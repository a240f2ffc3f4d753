"""zedo_tpu_torch batch CLIs (run.opt_main, run.inference) and what they
read (presets.optim_config, utils.config, models.registry, utils.checkpoint,
build_sde, get_sampling_fn, ZeDOConfig.from_config) against the JAX
package, and the slice as a whole: the committed trained fixture through
both packages' CLI functions on the CPU."""
import dataclasses
import importlib
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from zedo_tpu.diffusion.sampling import get_sampling_fn as j_get_sampling_fn
from zedo_tpu.diffusion.sde import build_sde as j_build_sde
from zedo_tpu.models.registry import make_mlp_config as j_make_mlp_config
from zedo_tpu.run import opt_main as jopt
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu.utils import config as jconfig
from zedo_tpu.zeroshot.pipeline import ZeDOConfig as JZeDOConfig
from zedo_tpu_torch import presets
from zedo_tpu_torch.diffusion.sampling import get_sampling_fn
from zedo_tpu_torch.diffusion.sde import build_sde
from zedo_tpu_torch.models import nn as tnn
from zedo_tpu_torch.models.registry import make_mlp_config
from zedo_tpu_torch.run import inference as tinf
from zedo_tpu_torch.run import opt_main as topt
from zedo_tpu_torch.utils import checkpoint as tckpt
from zedo_tpu_torch.utils import config as tconfig
from zedo_tpu_torch.zeroshot.pipeline import ZeDOConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained")
PTH = os.path.join(FIXTURE, "checkpoint", "checkpoint_trained.pth")
FILES = {"h36m": "h36m", "3dhp": "3dhp", "3dpw": "pw3d", "ski": "ski", "wild": "wild"}
DIMS = ("hidden_dim", "embed_dim", "n_blocks")
# the committed fixture's model, a short schedule, its 24 scenes unstrided
FIXTURE_OVERRIDES = ["model.hidden_dim=256", "model.embed_dim=128", "ZeDO.sample=1",
                     "ZeDO.batch=24"]
SHORT = ["ZeDO.IPO_iterations=60", "ZeDO.OIL_iterations=100"]


def jax_config(name):
    return importlib.import_module(f"configs.optim.concat_pose_optimization_{FILES[name]}") \
        .get_config()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _jax_get(config, path):
    node = config
    for p in path.split("."):
        assert p in node, path
        node = node[p]
    return node


@pytest.mark.parametrize("name", list(FILES))
def test_preset_equals_its_config_file(name):
    jc = jax_config(name)
    flat = _flat(presets.optim_config(name))
    for path, value in flat.items():
        if path.split(".")[-1] in DIMS:
            continue
        want = _jax_get(jc, path)
        assert value == want and type(value) is type(want), (path, value, want)
    # the published widths, which the files leave to the CLI's constants
    assert {d: flat[f"model.{d}"] for d in DIMS} == {"hidden_dim": 1024, "embed_dim": 512,
                                                      "n_blocks": 2}
    assert not any(d in jc.model for d in DIMS)


@pytest.mark.parametrize("name", list(FILES))
def test_config_consumers_match_jax(name):
    """make_mlp_config, build_sde, get_sampling_fn and from_config on each
    preset against the JAX functions on its file."""
    tc, jc = presets.optim_config(name), jax_config(name)
    assert dataclasses.asdict(make_mlp_config(tc)) == dataclasses.asdict(j_make_mlp_config(jc))
    tconfig.apply_overrides(tc, ["model.hidden_dim=256", "model.n_blocks=3"])
    with jc.unlocked():
        jc.model.hidden_dim, jc.model.n_blocks = 256, 3
    assert dataclasses.asdict(make_mlp_config(tc)) == dataclasses.asdict(j_make_mlp_config(jc))

    m = tc.model
    kw = dict(beta_min=m.beta_min, beta_max=m.beta_max, sigma_min=m.sigma_min,
              sigma_max=m.sigma_max, n=m.num_scales, t_max=m.t)
    sde, jsde = build_sde(tc.training.sde, **kw), j_build_sde(jc.training.sde, **kw)
    assert (sde.beta_min, sde.beta_max, sde.n, sde.t_max) == (
        jsde.beta_min, jsde.beta_max, jsde.n, jsde.t_max)
    tc.sampling.probability_flow = jc.sampling.probability_flow = True
    s = get_sampling_fn(tc, sde, (3, 17, 3), lambda x: x, tc.ZeDO.sampling_eps)
    js = j_get_sampling_fn(jc, jsde, (3, 17, 3), lambda x: x, jc.ZeDO.sampling_eps)
    for field in ("predictor", "corrector", "snr", "n_steps", "probability_flow",
                  "continuous", "denoise", "eps"):
        assert getattr(s, field) == getattr(js, field), field

    z, jz = ZeDOConfig.from_config(tc), JZeDOConfig.from_config(jc)
    assert dataclasses.asdict(z.ipo) == dataclasses.asdict(jz.ipo)
    for field in ("iterations", "sampling_eps", "fixed_t_steps", "score_reuse", "gn_fp32",
                  "track_reproj"):
        assert getattr(z.oil, field) == getattr(jz.oil, field), field
    assert z.oil.use_kernel is jz.oil.use_pallas is None
    tconfig.apply_overrides(tc, ["ZeDO.use_pallas=True", "ZeDO.gn_fp32=True",
                                 "ZeDO.score_reuse=2"])
    z = ZeDOConfig.from_config(tc)
    assert (z.oil.use_kernel, z.oil.gn_fp32, z.oil.score_reuse) == (True, True, 2)


def test_h36m_serving_preset_is_the_cli_configuration():
    p = presets.h36m(hidden_dim=256, embed_dim=128)
    q = presets.from_optim_config(tconfig.apply_overrides(
        presets.optim_config("h36m"), ["model.hidden_dim=256", "model.embed_dim=128"]))
    assert p == q
    with pytest.raises(TypeError, match="hidden_dim"):
        presets.h36m(group_norm_groups=16)


def test_unported_choices_raise():
    with pytest.raises(NotImplementedError, match="unknown"):
        build_sde("cld")
    sde = build_sde("subvpsde")
    c = presets.optim_config("h36m")
    c.sampling.method = "ode"  # ported since the full sampling surface
    assert type(get_sampling_fn(c, sde, (1, 17, 3), None, 0.01)).__name__ == "ODESampler"
    for key, value in (("method", "ddim"), ("predictor", "heun"), ("corrector", "nuts")):
        c = presets.optim_config("h36m")
        c.sampling[key] = value
        with pytest.raises(ValueError, match="unknown"):
            get_sampling_fn(c, sde, (1, 17, 3), None, 0.01)
    c = tconfig.apply_overrides(presets.optim_config("h36m"), ["ZeDO.pallas_interpret=True"])
    with pytest.raises(ValueError, match="pallas_interpret"):
        ZeDOConfig.from_config(c)
    with pytest.raises(KeyError, match="presets are"):
        presets.optim_config("cmu")


def test_apply_overrides_matches_jax():
    overrides = ["ZeDO.OIL_iterations=500", "sampling.snr=0.2", "ZeDO.IPO_keylist=[0, 1]",
                 "model.embedding_type=fourier", "ZeDO.gn_fp32=True"]
    tc = tconfig.apply_overrides(presets.optim_config("h36m"), overrides)
    jc = jconfig.apply_overrides(jax_config("h36m"), overrides)
    for item in overrides:
        path = item.split("=")[0]
        assert _jax_get(tc, path) == _jax_get(jc, path), path
    for bad, err in (("ZeDO.OIL_iterations", ValueError), ("ZeDO.nope=1", KeyError),
                     ("nope.x=1", KeyError)):
        for apply, config in ((tconfig.apply_overrides, presets.optim_config("h36m")),
                              (jconfig.apply_overrides, jax_config("h36m"))):
            with pytest.raises(err):
                apply(config, [bad])


def test_resolve_dtype_and_cli_int_arg():
    assert tconfig.resolve_dtype("auto", torch.device("cpu")) == "fp32"
    assert tconfig.resolve_dtype("auto", torch.device("cuda")) == "bf16"
    assert tconfig.resolve_dtype("fp32", torch.device("cuda")) == "fp32"
    assert tconfig.resolve_dtype("bf16", torch.device("cpu")) == "bf16"
    argv = ["x", "--n", "12", "--bad", "q"]
    for fn in (tconfig.cli_int_arg, jconfig.cli_int_arg):
        assert fn(argv, "--n", 3) == 12 and fn(argv, "--s", 3) == 3
        with pytest.raises(SystemExit, match="--bad"):
            fn(argv, "--bad", 1)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v.float() if torch.is_tensor(v) else v)


@pytest.mark.parametrize("use_ema", [False, True])
def test_load_any_checkpoint_matches_jax(use_ema):
    cfg = make_mlp_config(tconfig.apply_overrides(presets.optim_config("h36m"),
                                                  FIXTURE_OVERRIDES))
    jc = jax_config("h36m")
    with jc.unlocked():
        jc.model.hidden_dim, jc.model.embed_dim = 256, 128
    params, step = tckpt.load_any_checkpoint(PTH, cfg, use_ema=use_ema, device="cpu")
    jparams, jstep = jckpt.load_any_checkpoint(PTH, j_make_mlp_config(jc), use_ema=use_ema)
    assert step == jstep == 3000
    want = dict(_leaves(jparams))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].astype(got[key].dtype), err_msg=key)
    raw, _ = tckpt.load_any_checkpoint(PTH, cfg, device="cpu")
    assert use_ema != torch.equal(params["pre_dense"]["weight"], raw["pre_dense"]["weight"])


def test_ema_shadow_and_checkpoint_errors(tmp_path):
    cfg = make_mlp_config(tconfig.apply_overrides(presets.optim_config("h36m"),
                                                  FIXTURE_OVERRIDES))
    shadow = torch.load(PTH, map_location="cpu", weights_only=False)["ema"]["shadow_params"]
    tree = tckpt.ema_shadow_to_params(shadow, cfg, device="cpu")
    jtree = jckpt.ema_shadow_to_params([p.numpy() for p in shadow], cfg)
    for (k, v), (jk, jv) in zip(sorted(_leaves(tree)), sorted(_leaves(jtree))):
        assert k == jk
        np.testing.assert_array_equal(v, jv)
    with pytest.raises(ValueError, match="EMA shadow length"):
        tckpt.ema_shadow_to_params(shadow[:-1], cfg, device="cpu")
    # no EMA in the file: --ema notes it and keeps the raw weights
    ckpt = torch.load(PTH, map_location="cpu", weights_only=False)
    ckpt["ema"] = None
    torch.save(ckpt, tmp_path / "no_ema.pth")
    notes = []
    params, _ = tckpt.load_any_checkpoint(str(tmp_path / "no_ema.pth"), cfg, use_ema=True,
                                          log=notes.append, device="cpu")
    assert len(notes) == 1 and "no EMA" in notes[0]
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_any_checkpoint(os.path.join(FIXTURE, "checkpoint", "orbax_trained"), cfg,
                                  device="cpu")


def _argv(*extra, hypo=2, short=True):
    argv = ["--config", "h36m", "--device", "cpu", "--ckpt_dir",
            os.path.join(FIXTURE, "checkpoint"), "--ckpt_name", "checkpoint_trained.pth",
            "--cluster_dir", os.path.join(FIXTURE, "clusters"), "--data_dir",
            os.path.join(FIXTURE, "data"), "--gt", "--hypo", str(hypo), "--strict_batch",
            "--dtype", "fp32"]
    for o in FIXTURE_OVERRIDES + (SHORT if short else []):
        argv += ["--override", o]
    return argv + list(extra)


def _jax_cli(hypo, dtype="fp32", short=True):
    """JAX's opt_main functions on the fixture: (poses, p1 mm, p2 mm)."""
    config = jax_config("h36m")
    with config.unlocked():
        config.model.hidden_dim, config.model.embed_dim = 256, 128
    jconfig.apply_overrides(config, FIXTURE_OVERRIDES[2:] + (SHORT if short else []))
    args = types.SimpleNamespace(
        ckpt_dir=os.path.join(FIXTURE, "checkpoint"), ckpt_name="checkpoint_trained.pth",
        gt=True, hypo=hypo, ema=False, dtype=dtype, save=None, seed=0,
        cluster_dir=os.path.join(FIXTURE, "clusters"), data_dir=os.path.join(FIXTURE, "data"),
        strict_batch=True)
    ds = jopt.build_dataset(config, args)
    poses = jopt.run_pipeline(config, args, ds)
    return (poses, ds.eval_multi(poses, protocol2=False) * 1000,
            ds.eval_multi(poses, protocol2=True) * 1000)


@pytest.mark.parametrize("hypo", [1, 2])
def test_trained_fixture_through_both_clis(hypo, tmp_path, capsys):
    """The slice as a whole: fp32, IPO 60 / OIL 100, P1 and P2 within 0.5 mm."""
    jposes, jp1, jp2 = _jax_cli(hypo)
    save = str(tmp_path / "results.npy")
    out = topt.main(_argv("--save", save, hypo=hypo))
    printed = capsys.readouterr().out
    assert f"solved 24 poses x {hypo} hypotheses x 100 OIL steps on 1 device(s)" in printed
    assert printed.count("+------+") >= 6  # both protocols' tables
    assert out["poses"].shape == (24, hypo, 17, 3) and out["poses"].device.type == "cpu"
    np.testing.assert_array_equal(np.load(save), out["poses"].numpy())
    assert abs(out["p1"] * 1000 - jp1) < 0.5, (out["p1"] * 1000, jp1)
    assert abs(out["p2"] * 1000 - jp2) < 0.5, (out["p2"] * 1000, jp2)
    assert 0 < out["p2"] <= out["p1"]
    assert min(out[k] for k in ("solve_s", "eval_s", "ipo_s", "oil_s")) > 0


def test_config_file_paths_and_cli_errors(tmp_path):
    # a path is read as JAX reads the file: every key of it, the preset's
    # restated keys among them
    for name, suffix in (("3dpw", "pw3d"), ("mini", "mini")):
        module = f"configs.optim.concat_pose_optimization_{suffix}"
        flat = _flat(topt.load_config(os.path.join(REPO, *module.split(".")) + ".py"))
        assert flat == _flat(importlib.import_module(module).get_config().to_dict())
        assert all(flat[k] == v for k, v in _flat(presets.optim_config(name)).items()
                   if k.split(".")[-1] not in DIMS)
    with pytest.raises(FileNotFoundError, match="cfg_small.py"):
        topt.load_config("cfg_small.py")
    with pytest.raises(ValueError, match="h36m, 3dhp, 3dpw, ski, wild"):
        topt.load_config("mini")
    with pytest.raises(AssertionError, match="batch: 23, dataset len: 24"):
        topt.main(_argv("--override", "ZeDO.batch=23"))
    two = np.load(os.path.join(FIXTURE, "clusters", "h36m_cluster2.npy"))
    np.save(tmp_path / "h36m_cluster3.npy", two)
    with pytest.raises(ValueError, match="provides 2 poses but --hypo=3"):
        topt.main(_argv("--cluster_dir", str(tmp_path), hypo=3))
    with pytest.raises(FileNotFoundError, match="h36m_cluster7"):
        topt.main(_argv(hypo=7))


def test_profile_flag_writes_a_trace(tmp_path):
    out = topt.main(_argv("--profile", str(tmp_path / "trace"), "--override",
                          "ZeDO.OIL_iterations=3", "--override", "ZeDO.IPO_iterations=2",
                          hypo=1))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert np.isfinite(out["poses"].numpy()).all()


def test_clis_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    for main in (topt.main, tinf.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", "h36m"])


def test_inference_writes_results_and_evaluates(tmp_path, capsys):
    """run.inference on a wild custom_data.npz: the .npy, and with --eval the
    same errors as the JAX package's inference path on the same file."""
    rng = np.random.RandomState(8)
    n = 6
    gt3d = rng.randn(n, 17, 3).astype(np.float32) * 0.25
    gt3d -= gt3d[:, 0:1]
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1000.0
    k[:, 0, 2] = k[:, 1, 2] = 500.0
    k[:, 2, 2] = 1.0
    cam = gt3d + np.array([0.1, 0.0, 4.0], np.float32)
    kp2d = np.concatenate([cam[..., :2] / cam[..., 2:] * 1000.0 + 500.0,
                           np.ones((n, 17, 1), np.float32)], axis=-1).astype(np.float32)
    (tmp_path / "data" / "wild").mkdir(parents=True)
    np.savez(tmp_path / "data" / "wild" / "custom_data.npz", keypoints_2d=kp2d,
             keypoints_3d=gt3d, K=k, image_name=np.array([f"im{i}" for i in range(n)]))
    overrides = ["ZeDO.sample=1", f"ZeDO.batch={n}", "ZeDO.IPO_iterations=30",
                 "ZeDO.OIL_iterations=20"]
    save = str(tmp_path / "wild_results.npy")
    argv = ["--config", "wild", "--device", "cpu", "--ckpt_dir",
            os.path.join(FIXTURE, "checkpoint"), "--ckpt_name", "checkpoint_trained.pth",
            "--cluster_dir", os.path.join(FIXTURE, "clusters"), "--data_dir",
            str(tmp_path / "data"), "--hypo", "1", "--strict_batch", "--save", save]
    for o in ["model.hidden_dim=256", "model.embed_dim=128"] + overrides:
        argv += ["--override", o]
    out = tinf.main(argv)
    assert "p1" not in out
    saved = np.load(save)
    assert saved.shape == (n, 1, 17, 3) and np.isfinite(saved).all()
    assert f"saved results to {save}" in capsys.readouterr().out
    out = tinf.main(argv + ["--eval"])
    np.testing.assert_array_equal(np.load(save), saved)

    config = jax_config("wild")
    with config.unlocked():
        config.model.hidden_dim, config.model.embed_dim = 256, 128
    jconfig.apply_overrides(config, overrides)
    args = types.SimpleNamespace(
        ckpt_dir=os.path.join(FIXTURE, "checkpoint"), ckpt_name="checkpoint_trained.pth",
        gt=False, hypo=1, ema=False, dtype="fp32", seed=0, strict_batch=True,
        cluster_dir=os.path.join(FIXTURE, "clusters"), data_dir=str(tmp_path / "data"))
    ds = jopt.build_dataset(config, args)
    poses = jopt.run_pipeline(config, args, ds)
    for key, protocol2 in (("p1", False), ("p2", True)):
        assert abs(out[key] - ds.eval_multi(poses, protocol2=protocol2)) < 5e-4, key


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_cli_reference():
    """chip_smoke.py holds the port's CLI on the card to the JAX CLI's P1/P2
    on the trained fixture at the full schedule; recompute those values."""
    smoke = _smoke()
    assert set(smoke.JAX_CLI_FIXTURE_MM) == {"fp32", "bf16"}
    for dtype, (p1, p2) in smoke.JAX_CLI_FIXTURE_MM.items():
        _, jp1, jp2 = _jax_cli(smoke.CLI_FIXTURE_HYPO, dtype=dtype, short=False)
        assert abs(jp1 - p1) < 1e-2 and abs(jp2 - p2) < 1e-2, (dtype, jp1, jp2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TINY = ["model.hidden_dim=64", "model.embed_dim=32", "model.n_blocks=1", "model.num_scales=20",
        "training.batch_size=16", "eval.batch_size=8"]


def _train(root, *flags, name="run"):
    from zedo_tpu_torch.run import train_pose_mini

    argv = ["--config", "mini", "--device", "cpu", "--epochs", "2", "--log_name", name]
    for item in TINY + [f"OUTPUT_DIR={root}/output"]:
        argv += ["--override", item]
    return train_pose_mini.main(argv + list(flags))


def _flat_params(tree):
    return {k: v.detach() for k, v in tnn.tree_to_flat(tree).items()}


def test_train_cli_on_a_mini_workspace(tmp_path, monkeypatch, capsys):
    """run.train_pose_mini on a synthetic MINI-RGBD workspace: two epochs
    with an eval epoch (finite Mahalanobis and micro-solve MPJPE), a
    checkpoint that run.sample and run.opt_main_infant read, a resume equal
    to the uninterrupted run, the ControlNet adapter
    fine-tuned from the checkpoint with its trunk frozen, the conditional
    prior, and the refusals."""
    from zedo_tpu_torch.models import control_mlp as tcm
    from zedo_tpu_torch.run import opt_main_infant, sample
    from zedo_tpu_torch.run import train_pose_mini

    monkeypatch.chdir(tmp_path)
    # TensorBoard is optional, as in the JAX CLI; its import alone takes
    # seconds where TensorFlow is installed, so these runs go without it
    # (the trainer's scalars: tests/test_torch_train.py)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _chip_smoke().write_mini_workspace(str(tmp_path), np.random.RandomState(0), 12, n_train=40)
    out = _train(tmp_path)
    state, ckpt = out["state"], os.path.join(out["output_dir"], "checkpoint_0.pth")
    assert state.step == 4 and len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    assert set(out["eval_history"][0]) == {"prior_mahalanobis", "zeroshot_mpjpe_mm"}
    assert np.isfinite(list(out["eval_history"][0].values())).all()
    assert np.load(os.path.join(out["output_dir"], "results_0.npy")).shape == (8, 17, 3)

    capsys.readouterr()
    resumed = _train(tmp_path, "--restore_dir", ckpt, name="resumed")
    assert "at epoch 1, step 2" in capsys.readouterr().err
    assert resumed["state"].step == state.step and len(resumed["history"]) == 1
    got, want = _flat_params(resumed["state"].params), _flat_params(state.params)
    assert all(torch.equal(got[k], want[k]) for k in want)

    sampled = sample.main(["--config", "mini", "--device", "cpu", "--ckpt_dir",
                           out["output_dir"], "--ckpt_name", "checkpoint_0.pth", "--num", "4",
                           "--save", str(tmp_path / "s.npy"), "--ema",
                           *sum((["--override", o] for o in TINY), [])])
    assert torch.isfinite(sampled["samples"]).all()
    solved = opt_main_infant.main(["--config", "mini", "--device", "cpu", "--ckpt_dir",
                                   out["output_dir"], "--ckpt_name", "checkpoint_0.pth",
                                   *sum((["--override", o] for o in TINY + [
                                       "ZeDO.IPO_iterations=5", "ZeDO.OIL_iterations=5"]), [])])
    assert np.isfinite(solved["mpjpe"])

    control = _train(tmp_path, "--model", "control", "--fine_tune", "--fine_tune_ckpt", ckpt,
                     "--epochs", "1", name="control")
    tuned = _flat_params(control["state"].params)
    trunk = _flat_params(tckpt.load_torch_checkpoint(ckpt, state_cfg(), device="cpu")["params"])
    for name, value in tuned.items():
        if name in trunk:
            assert torch.equal(value, trunk[name]), name
    # the adapter's own leaves moved from where the fine-tune started them
    init = _flat_params(tcm.init_params(torch.Generator().manual_seed(42), state_cfg(),
                                        device="cpu"))
    for name in ("zc_layer_2.weight", "infant_cond"):
        assert not torch.equal(tuned[name], init[name]), name
    assert not torch.equal(tuned["pre_dense_copy.weight"], trunk["pre_dense.weight"])
    cond = _train(tmp_path, "--model", "cond", "--epochs", "1", "--rotflip", name="cond")
    assert np.isfinite(cond["history"]).all()

    for flags, err, msg in ((["--mesh", "dp2"], ValueError, "needs 2 devices, have 1"),
                            (["--model", "cond", "--aug"], SystemExit, "--aug"),
                            (["--fine_tune"], ValueError, "--fine_tune_ckpt")):
        with pytest.raises(err, match=msg):
            _train(tmp_path, *flags, name="refused")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_pose_mini.main(["--config", "mini"])


def state_cfg():
    return make_mlp_config(tconfig.apply_overrides(presets.optim_config("mini"), TINY))
