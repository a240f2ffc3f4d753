"""zedo_tpu_torch serving (ZeDOEstimator) and the H36M preset against the
JAX package."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from zedo_tpu import serving as jserving
from zedo_tpu.diffusion.sampling import get_sampling_fn
from zedo_tpu.models.registry import make_mlp_config
from zedo_tpu.zeroshot.pipeline import ZeDOConfig as JZeDOConfig
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch.data.sharding import pad_batch, unpad
from zedo_tpu_torch.serving import ZeDOEstimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_config(path):
    spec = importlib.util.spec_from_file_location("zedo_test_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config()


def test_low_latency_predict_matches_jax():
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    gt, k, px = tbt.make_scenes(family, 8)
    jest = jserving.ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS,
        config_path=os.path.join(REPO, "examples", "quickstart_config.py"),
        dtype="fp32", batch_bucket=32).low_latency()
    preset = presets.h36m(hidden_dim=int(family["hidden"]), embed_dim=int(family["embed"]))
    test = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=preset, dtype="fp32", batch_bucket=32,
        device="cpu").low_latency()
    assert test.sde.n == test.zcfg.oil.iterations == 200
    assert test.zcfg.ipo.iterations == 100
    want = jest.predict(px, k)
    got = test.predict(px, k)
    assert got["poses"].shape == (8, 2, 17, 3)
    np.testing.assert_array_equal(got["best"], want["best"])
    # IPO from cluster inits amplifies f32 rounding differences between the
    # frameworks (tests/test_torch_pipeline.py); held at 2 mm
    np.testing.assert_allclose(got["poses"], want["poses"], atol=2e-3)
    np.testing.assert_allclose(got["translations"], want["translations"], atol=2e-2)
    np.testing.assert_allclose(got["reprojection_error"], want["reprojection_error"],
                               rtol=1e-2, atol=0.1)
    best = got["poses"][np.arange(8), got["best"]][:, None]
    assert tbt.best_mpjpe(best, gt) < 100.0  # solved, far below the ~684 mm init


def test_h36m_preset_matches_shared_config():
    config = _load_config(os.path.join(REPO, "configs", "optim",
                                       "concat_pose_optimization_h36m.py"))
    p = presets.h36m()
    want_model = dataclasses.asdict(make_mlp_config(config))
    assert dataclasses.asdict(p.model_cfg) == want_model
    jz = JZeDOConfig.from_config(config)
    assert dataclasses.asdict(p.zcfg.ipo) == dataclasses.asdict(jz.ipo)
    for name in ("iterations", "sampling_eps", "fixed_t_steps", "score_reuse", "gn_fp32",
                 "track_reproj"):
        assert getattr(p.zcfg.oil, name) == getattr(jz.oil, name), name
    m = config.model
    assert config.training.sde == "subvpsde"
    assert (p.sde.beta_min, p.sde.beta_max, p.sde.n, p.sde.t_max) == (
        m.beta_min, m.beta_max, m.num_scales, m.t)
    config.sampling.probability_flow = True  # serving forces the probability flow
    js = get_sampling_fn(config, None, (1, 17, 3), lambda x: x, config.ZeDO.sampling_eps)
    for name in ("predictor", "corrector", "snr", "n_steps", "probability_flow",
                 "continuous", "denoise", "eps"):
        assert getattr(p.sampler, name) == getattr(js, name), name


def test_pad_batch_and_unpad():
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, mask = pad_batch({"a": a, "none": None}, 4)
    assert padded["a"].shape == (8, 2) and padded["none"] is None
    np.testing.assert_array_equal(padded["a"][5:], np.repeat(a[-1:], 3, 0))
    np.testing.assert_array_equal(mask, [1, 1, 1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(unpad(padded["a"], mask), a)
    with pytest.raises(ValueError):
        pad_batch([None], 4)


def test_estimator_rejects_bad_dtype():
    with pytest.raises(ValueError, match="dtype"):
        ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS, dtype="fp16",
                                            device="cpu")


def test_bf16_estimator_on_cpu_is_finite():
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    _, k, px = tbt.make_scenes(family, 3)
    preset = presets.h36m(hidden_dim=256, embed_dim=128)
    est = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=preset, dtype="bf16", batch_bucket=4,
        device="cpu").with_schedule(20, ipo_iterations=10)
    assert est.params["post_dense"]["weight"].dtype == torch.bfloat16
    out = est.predict(px, k, confidence=np.ones((3, 17), np.float32))
    assert np.isfinite(out["poses"]).all() and out["best"].shape == (3,)
