"""zedo_tpu_torch reads config files as the JAX package's CLIs and serving
read them (presets.read_config_file, without ml_collections), and the last
names of the JAX surface: solve_one_hypothesis(generator=, reproj_weight=),
mini_rgbd.save_action, eval_multi(sample=, mask_tok=), VPSDE.alphas_cumprod,
run_pipeline(logger_print=) and the subpackages' exports. Each against the
JAX package on the CPU."""
import glob
import importlib
import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zedo_tpu.data as jdata
from zedo_tpu import bench_trained as jbt
from zedo_tpu import serving as jserving
from zedo_tpu.diffusion.sampling import PCSampler as JPCSampler
from zedo_tpu.diffusion.sde import SubVPSDE as JSubVPSDE
from zedo_tpu.diffusion.sde import VPSDE as JVPSDE
from zedo_tpu.run import opt_main as jopt
from zedo_tpu.zeroshot import ipo as jipo
from zedo_tpu.zeroshot import oil as joil
from zedo_tpu.zeroshot import pipeline as jpipe
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch.data.mini_rgbd import mini_rgbd
from zedo_tpu_torch.data.syrip import syrip
from zedo_tpu_torch.diffusion.sampling import PCSampler as TPCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE as TSubVPSDE
from zedo_tpu_torch.diffusion.sde import VPSDE as TVPSDE
from zedo_tpu_torch.run import opt_main as topt
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.zeroshot import ipo as tipo
from zedo_tpu_torch.zeroshot import oil as toil
from zedo_tpu_torch.zeroshot import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained")
QUICKSTART_CONFIG = os.path.join(REPO, "examples", "quickstart_config.py")
CONFIG_FILES = sorted(p for p in glob.glob(os.path.join(REPO, "configs", "optim", "*.py"))
                      if not os.path.basename(p).startswith("_")) + [QUICKSTART_CONFIG]
# a user's wrapper of the stock H36M file: the fixture's widths, its 24
# scenes unstrided, a short schedule
WRAPPER = """import configs.optim.concat_pose_optimization_h36m as base


def get_config():
    config = base.get_config()
    with config.unlocked():
        config.model.hidden_dim = 256
        config.model.embed_dim = 128
        config.ZeDO.sample = 1
        config.ZeDO.batch = 24
        config.ZeDO.IPO_iterations = 60
        config.ZeDO.OIL_iterations = 100
    return config
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if hasattr(v, "items") else {prefix + k: v})
    return out


def _stand_in_modules():
    return {name: module for name, module in sys.modules.items()
            if name.split(".")[0] in ("configs", "ml_collections")}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("path", CONFIG_FILES, ids=os.path.basename)
def test_config_file_equals_jax(path):
    """Every key and value of the file, read by the port, as JAX reads it."""
    got = _flat(presets.load_config(path))
    want = _flat(jserving._load_config(path).to_dict())
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key] == value and type(got[key]) is type(value), (key, got[key], value)
    assert isinstance(presets.load_config(path), presets.Config)


def test_reading_leaves_the_modules_as_it_found_them():
    """The configs and ml_collections modules loaded before are put back,
    the same objects; JAX's config modules still build ml_collections
    ConfigDicts; sys.path is restored."""
    import ml_collections

    jax_file = importlib.import_module("configs.optim.concat_pose_optimization_h36m")
    before, path_before = _stand_in_modules(), list(sys.path)
    config = presets.load_config(QUICKSTART_CONFIG)
    assert _stand_in_modules() == before and sys.path == path_before
    assert (config.model.hidden_dim, config.model.embed_dim) == (256, 128)
    assert isinstance(config.model, presets.Config)
    assert sys.modules["ml_collections"] is ml_collections
    assert isinstance(jax_file.get_config(), ml_collections.ConfigDict)
    again = importlib.import_module("configs.optim.concat_pose_optimization_mini").get_config()
    assert isinstance(again, ml_collections.ConfigDict)


_NO_ML_COLLECTIONS = """
import sys
sys.modules["ml_collections"] = None  # as on a machine without it
from zedo_tpu_torch import presets
config = presets.load_config({path!r})
left = sorted(n for n in sys.modules if n.split(".")[0] in ("configs", "ml_collections"))
print("LEFT", left, sys.modules["ml_collections"])
print("WIDTHS", config.model.hidden_dim, config.model.embed_dim, config.ZeDO.batch)
"""


def test_reads_a_file_where_ml_collections_cannot_be_imported():
    out = subprocess.run([sys.executable, "-c", _NO_ML_COLLECTIONS.format(path=QUICKSTART_CONFIG)],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "LEFT ['ml_collections'] None" in out.stdout, out.stdout
    assert "WIDTHS 256 128 886" in out.stdout, out.stdout


def test_config_file_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="cfg_small.py"):
        presets.load_config(str(tmp_path / "cfg_small.py"))
    with pytest.raises(ValueError, match="give a preset"):
        presets.load_config("mini")
    # a file that fails leaves the modules as they were
    before = _stand_in_modules()
    bad = tmp_path / "bad.py"
    bad.write_text("import ml_collections\n\ndef get_config():\n    raise KeyError('x')\n")
    with pytest.raises(KeyError):
        presets.load_config(str(bad))
    assert _stand_in_modules() == before
    # the stand-in's ConfigDict takes an initial dict, and unlocked() / lock()
    config = presets.Config({"a": {"b": 1}}, c=2)
    with config.unlocked():
        config.a.b = 3
    assert config.lock() is config and config == {"a": {"b": 3}, "c": 2}


def test_wrapper_config_through_both_clis(tmp_path, capsys):
    """The slice as a whole: a user's wrapper config through the port's
    run.opt_main and JAX's CLI functions on the fixture, fp32; P1 / P2
    within 0.5 mm, as test_torch_cli.py holds the two CLIs."""
    wrapper = tmp_path / "cfg_small.py"
    wrapper.write_text(WRAPPER)
    argv = ["--config", str(wrapper), "--device", "cpu", "--ckpt_dir",
            os.path.join(FIXTURE, "checkpoint"), "--ckpt_name", "checkpoint_trained.pth",
            "--cluster_dir", os.path.join(FIXTURE, "clusters"), "--data_dir",
            os.path.join(FIXTURE, "data"), "--gt", "--hypo", "2", "--strict_batch",
            "--dtype", "fp32"]
    out = topt.main(argv)
    assert "solved 24 poses x 2 hypotheses x 100 OIL steps" in capsys.readouterr().out
    config = jserving._load_config(str(wrapper))
    args = types.SimpleNamespace(
        ckpt_dir=os.path.join(FIXTURE, "checkpoint"), ckpt_name="checkpoint_trained.pth",
        gt=True, hypo=2, ema=False, dtype="fp32", save=None, seed=0,
        cluster_dir=os.path.join(FIXTURE, "clusters"), data_dir=os.path.join(FIXTURE, "data"),
        strict_batch=True)
    ds = jopt.build_dataset(config, args)
    poses = jopt.run_pipeline(config, args, ds)
    jp1, jp2 = ds.eval_multi(poses, protocol2=False), ds.eval_multi(poses, protocol2=True)
    assert abs(out["p1"] - jp1) * 1000 < 0.5, (out["p1"], jp1)
    assert abs(out["p2"] - jp2) * 1000 < 0.5, (out["p2"], jp2)
    # --override works on what the file gives
    with pytest.raises(AssertionError, match="batch: 23, dataset len: 24"):
        topt.main(argv + ["--override", "ZeDO.batch=23"])


def test_config_path_estimator_matches_jax():
    """from_torch_checkpoint(config_path=...) takes the file's widths and
    schedule; its low-latency predict against JAX's at the tolerances of
    test_torch_serving.py::test_low_latency_predict_matches_jax."""
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    gt, k, px = tbt.make_scenes(family, 8)
    jest = jserving.ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, config_path=QUICKSTART_CONFIG, dtype="fp32",
        batch_bucket=32).low_latency()
    test = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, config_path=QUICKSTART_CONFIG, dtype="fp32",
        batch_bucket=32, device="cpu")
    assert (test.model_cfg.hidden_dim, test.model_cfg.embed_dim) == (256, 128)
    assert test.zcfg.oil.iterations == 1000 and test.zcfg.ipo.iterations == 500
    test = test.low_latency()
    want, got = jest.predict(px, k), test.predict(px, k)
    np.testing.assert_array_equal(got["best"], want["best"])
    np.testing.assert_allclose(got["poses"], want["poses"], atol=2e-3)
    np.testing.assert_allclose(got["translations"], want["translations"], atol=2e-2)
    np.testing.assert_allclose(got["reprojection_error"], want["reprojection_error"],
                               rtol=1e-2, atol=0.1)
    for bad in (dict(config="h36m"), dict(preset=presets.h36m())):
        with pytest.raises(ValueError, match="not both"):
            ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS, device="cpu",
                                                config_path=QUICKSTART_CONFIG, **bad)


# ------------------------------------------------- solve_one_hypothesis
IPO_ITERS, OIL_ITERS, N = 60, 25, 5


@pytest.fixture(scope="module")
def fixture():
    jcfg, jparams, family = jbt.load_fixture()
    tcfg, tparams, _ = tbt.load_fixture(device="cpu")
    _, k, px = tbt.make_scenes(family, N)
    clusters = tbt.make_hypothesis_clusters(family, 2)
    return jcfg, jparams, tcfg, tparams, k, px, clusters


def test_solve_one_hypothesis_reproj_weight_matches_jax(fixture):
    """The trace under a per-sample weight, with the poses, against JAX's
    solve_one_hypothesis at test_torch_pipeline.py's solve tolerances."""
    jcfg, jparams, tcfg, tparams, k, px, clusters = fixture
    w = np.random.RandomState(3).rand(N).astype(np.float32)
    w /= w.sum()
    jsde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=OIL_ITERS, t_max=0.1)
    want = jpipe.solve_one_hypothesis(
        jparams, jcfg, jsde, JPCSampler(sde=jsde, eps=0.01),
        jpipe.ZeDOConfig(ipo=jipo.IPOConfig(iterations=IPO_ITERS),
                         oil=joil.OILConfig(iterations=OIL_ITERS, track_reproj=True)),
        jnp.asarray(clusters[1]), jnp.asarray(px), None, jnp.asarray(k),
        rng=jax.random.PRNGKey(0), precision=jax.lax.Precision.HIGHEST,
        reproj_weight=jnp.asarray(w))
    tsde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=OIL_ITERS, t_max=0.1)
    got = tpipe.solve_one_hypothesis(
        tparams, tcfg, tsde, TPCSampler(sde=tsde, eps=0.01),
        tpipe.ZeDOConfig(ipo=tipo.IPOConfig(iterations=IPO_ITERS),
                         oil=toil.OILConfig(iterations=OIL_ITERS, track_reproj=True)),
        torch.tensor(clusters[1]), torch.tensor(px), None, torch.tensor(k),
        reproj_weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4, rtol=1e-3)
    assert got.reproj_px.shape == (1, OIL_ITERS)
    np.testing.assert_allclose(got.reproj_px.numpy()[0], np.asarray(want.reproj_px),
                               rtol=1e-3)
    unweighted = tpipe.solve_one_hypothesis(
        tparams, tcfg, tsde, TPCSampler(sde=tsde, eps=0.01),
        tpipe.ZeDOConfig(ipo=tipo.IPOConfig(iterations=IPO_ITERS),
                         oil=toil.OILConfig(iterations=OIL_ITERS, track_reproj=True)),
        torch.tensor(clusters[1]), torch.tensor(px), None, torch.tensor(k))
    assert not np.allclose(unweighted.reproj_px.numpy(), got.reproj_px.numpy(), rtol=1e-3)


def test_solve_one_hypothesis_takes_the_generator(fixture):
    """On the generic path (a Langevin corrector) the noise is the
    caller's generator: one seed twice gives the same poses, two seeds
    different ones."""
    _, _, tcfg, tparams, k, px, clusters = fixture
    sde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=50, t_max=0.1)
    zcfg = tpipe.ZeDOConfig(ipo=tipo.IPOConfig(iterations=40), oil=toil.OILConfig(iterations=50))
    sampler = TPCSampler(sde=sde, corrector="langevin", eps=0.01)

    def solve(seed):
        return tpipe.solve_one_hypothesis(
            tparams, tcfg, sde, sampler, zcfg, torch.tensor(clusters[0]), torch.tensor(px),
            None, torch.tensor(k), generator=torch.Generator().manual_seed(seed)).pose

    a, b, c = solve(1), solve(1), solve(2)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert (a - c).abs().max() > 1e-4


# ------------------------------------------------------------ the rest
def test_alphas_cumprod_matches_jax():
    for n in (1000, 50):
        got = TVPSDE(beta_min=0.1, beta_max=20.0, n=n).alphas_cumprod(torch.zeros(1))
        want = np.asarray(JVPSDE(beta_min=0.1, beta_max=20.0, n=n).alphas_cumprod)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        sde = TVPSDE(n=n)
        like = torch.zeros(1)
        torch.testing.assert_close(sde.sqrt_alphas_cumprod(like),
                                   torch.sqrt(sde.alphas_cumprod(like)))
        torch.testing.assert_close(sde.sqrt_1m_alphas_cumprod(like),
                                   torch.sqrt(1.0 - sde.alphas_cumprod(like)))


def test_infant_readers_save_action_and_eval_multi_keywords(tmp_path, monkeypatch, capsys):
    """save_action on the trained fixture's poses as MINI-RGBD frames, as
    JAX's; eval_multi's sample= and mask_tok= accepted and unused in both
    readers."""
    smoke = _smoke()
    monkeypatch.chdir(tmp_path)
    smoke.write_infant_fixture_workspace(".", tbt)
    smoke.write_syrip_workspace(".", np.random.RandomState(5), 6)
    kw = dict(gt2d=True, read_confidence=False, sample_interval=1, num_joint=17)
    mine, ref = mini_rgbd("validate", **kw), jdata.mini_rgbd("validate", **kw)
    labels = np.arange(len(ref.db_3d)) % 15
    np.testing.assert_array_equal(mine.save_action(labels), ref.save_action(labels))
    assert mine.action is labels
    for reader in (mine, ref):
        with pytest.raises(AssertionError):
            reader.save_action(labels[:-1])
    rs = np.random.RandomState(1)
    for reader in (mine, syrip("validate", gt2d=True, read_confidence=False, num_joint=12)):
        preds = (reader.db_3d[:, None] + rs.randn(len(reader.db_3d), 2, *reader.db_3d.shape[1:])
                 * 0.01).astype(np.float32)
        for protocol2 in (False, True):
            plain = reader.eval_multi(preds, protocol2=protocol2)
            assert reader.eval_multi(preds, protocol2=protocol2, sample=3,
                                     mask_tok=np.ones(5)) == plain
    capsys.readouterr()


def test_run_pipeline_logs_through_logger_print():
    config = presets.load_config(QUICKSTART_CONFIG)
    config.ZeDO.update(sample=1, batch=24, IPO_iterations=5, OIL_iterations=5)
    args = types.SimpleNamespace(
        ckpt_dir=os.path.join(FIXTURE, "checkpoint"), ckpt_name="checkpoint_trained.pth",
        gt=True, hypo=1, ema=False, dtype="auto", seed=0, device="cpu",
        cluster_dir=os.path.join(FIXTURE, "clusters"), data_dir=os.path.join(FIXTURE, "data"),
        strict_batch=True)
    lines = []
    poses = topt.run_pipeline(config, args, topt.build_dataset(config, args),
                              logger_print=lines.append)
    assert poses.shape == (24, 1, 17, 3)
    assert lines[0].startswith("loading model from ") and "checkpoint_trained.pth" in lines[0]
    assert lines[1].startswith("=> loaded checkpoint") and "(step 3000)" in lines[1]
    assert lines[2] == "--dtype auto -> fp32 on cpu"
    assert lines[3].startswith("solved 24 poses x 1 hypotheses x 5 OIL steps") and len(lines) == 4


_EXPORTS = """
import zedo_tpu_torch.diffusion as diffusion, zedo_tpu_torch.models as models
import zedo_tpu_torch.ops as ops, zedo_tpu_torch.zeroshot as zeroshot
for package, names in ((diffusion, "ema losses ode sampling score sde"),
                       (models, "nn score_mlp"),
                       (ops, "camera gradient_field linalg metrics procrustes rotations"),
                       (zeroshot, "ipo oil pipeline")):
    for name in names.split():
        assert getattr(package, name).__name__ == package.__name__ + "." + name, name
    assert package.__all__ == names.split()
print("EXPORTS OK")
"""


def test_subpackages_export_their_modules():
    """As JAX's do, in a fresh process: `import zedo_tpu_torch.ops as ops;
    ops.camera` is the module."""
    out = subprocess.run([sys.executable, "-c", _EXPORTS], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "EXPORTS OK" in out.stdout
