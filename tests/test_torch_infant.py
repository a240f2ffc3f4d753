"""zedo_tpu_torch infant path (zeroshot/infant.py, data/mini_rgbd.py,
data/syrip.py, the mini and syrip presets, run/opt_main_infant.py) against
the JAX package and the reference's committed reader golden.

Tolerances: the helpers 1e-5 relative (f32 rounding); solve_infant and the
CLIs' saved poses the ones test_torch_pipeline.py holds pipeline.solve to
(1e-4 m absolute, 1e-3 relative), the reprojection trace 1e-3 relative;
readers equal; evaluations 1e-5 relative."""
import importlib
import importlib.util
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

import zedo_tpu.data as jdata
from zedo_tpu.diffusion.sampling import PCSampler as JPCSampler
from zedo_tpu.diffusion.sde import SubVPSDE as JSubVPSDE
from zedo_tpu.models import control_mlp as jcm
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.models import score_mlp_cond as jcond
from zedo_tpu.models.registry import make_mlp_config as j_make_mlp_config
from zedo_tpu.zeroshot import infant as jinf
from zedo_tpu.zeroshot import ipo as jipo
from zedo_tpu.zeroshot import oil as joil
from zedo_tpu.zeroshot import pipeline as jpipe
from zedo_tpu_torch import presets
from zedo_tpu_torch.diffusion.sampling import PCSampler as TPCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE as TSubVPSDE
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models import score_mlp_cond as tcond
from zedo_tpu_torch.run import opt_main_infant as tcli
from zedo_tpu_torch.utils import config as tconfig
from zedo_tpu_torch.utils.checkpoint import params_from_numpy
from zedo_tpu_torch.zeroshot import infant as tinf
from zedo_tpu_torch.zeroshot import ipo as tipo
from zedo_tpu_torch.zeroshot import oil as toil
from zedo_tpu_torch.zeroshot import pipeline as tpipe

# the modules (the data package exports the classes under their names)
tmini = importlib.import_module("zedo_tpu_torch.data.mini_rgbd")
tsyrip = importlib.import_module("zedo_tpu_torch.data.syrip")
jmini = importlib.import_module("zedo_tpu.data.mini_rgbd")
jsyrip = importlib.import_module("zedo_tpu.data.syrip")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL, POSE_RTOL, TRACE_RTOL = 1e-4, 1e-3, 1e-3
FILES = {"mini": "mini", "syrip": "syrip"}
MODES = {17: "joint0", 12: "mean03"}
SHORT = ["ZeDO.IPO_iterations=20", "ZeDO.OIL_iterations=20"]
SMALL = ["model.hidden_dim=128", "model.embed_dim=64"]


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def scene(n_joints, n=5, seed=0):
    """Infant-sized poses at 1 m, their pixels under a Kinect-like K, and
    two cluster poses near them (IPO from a far init turns f32 rounding into
    millimetres in either package)."""
    rs = np.random.RandomState(seed)
    cam = smoke().infant_scenes(rs, n, n_joints, 1.0)
    k = np.tile(tmini.mini_intrinsics(), (n, 1, 1))
    px = smoke().pinhole(cam, tmini.mini_intrinsics())
    rel = cam[0] - cam[0, :1]
    clusters = np.stack([rel, rel + rs.randn(*rel.shape) * 0.01]).astype(np.float32)
    return cam, px, k, clusters


def test_helpers_match_jax():
    for n_joints, mode in MODES.items():
        cam, px, k, clusters = scene(n_joints)
        t = cam[:, :1] * 1.1
        close(tinf.pelvis_2d(torch.from_numpy(px), mode), jinf.pelvis_2d(jnp.asarray(px), mode))
        close(tinf.init_translation_infant(torch.from_numpy(px), torch.from_numpy(k), 1.0, mode),
              jinf.init_translation_infant(jnp.asarray(px), jnp.asarray(k), 1.0, mode))
        close(tinf.ray_init_pose(torch.from_numpy(px), torch.from_numpy(k), torch.from_numpy(t),
                                 mode),
              jinf.ray_init_pose(jnp.asarray(px), jnp.asarray(k), jnp.asarray(t), mode))
        close(tinf.find_closest(torch.from_numpy(clusters[1]), torch.from_numpy(cam)),
              jinf.find_closest(jnp.asarray(clusters[1]), jnp.asarray(cam)))
    close(tinf.max_bone_length(torch.from_numpy(cam)), jinf.max_bone_length(jnp.asarray(cam)))
    with pytest.raises(ValueError):
        tinf.pelvis_2d(torch.from_numpy(px), "joint7")


def models(kind, n_joints):
    jmod, tmod = {"plain": (jsm, tsm), "control": (jcm, tcm), "cond": (jcond, tcond)}[kind]
    kw = dict(n_joints=n_joints, hidden_dim=128, embed_dim=64)
    jcfg, tcfg = jsm.ScoreMLPConfig(**kw), tsm.ScoreMLPConfig(**kw)
    jparams = jmod.init_params(jax.random.PRNGKey(1), jcfg)
    # a random prior at full output scale throws the poses metres away
    jparams["post_dense"] = jax.tree.map(lambda a: a * 0.05, jparams["post_dense"])
    if kind == "control":
        # the copy branch apart from the trunk it starts as, so that a fault
        # in the control stream cannot hide behind the trunk's numbers
        rng = np.random.RandomState(2)
        for name in [k for k in jparams if k.endswith("_copy")]:
            jparams[name] = jax.tree.map(
                lambda a: a * jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
                jparams[name])
    return jmod, tmod, jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("n_joints", [17, 12])
@pytest.mark.parametrize("kind", ["plain", "cond", "control"])
def test_solve_infant_matches_jax(n_joints, kind):
    """S = 2 over 5 samples, 40 IPO / 30 OIL steps (T re-solved from step
    28), the conditional model conditioned per sample; the ControlNet
    adapter on the port's fast path (use_kernel forced: kernel #3's plain
    version, its folded weights and step tables) against JAX's generic
    path, which share one deterministic step."""
    jmod, tmod, jcfg, tcfg, jparams, tparams = models(kind, n_joints)
    _, px, k, clusters = scene(n_joints)
    mode, steps = MODES[n_joints], 30
    jsde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=steps, t_max=0.1)
    tsde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=steps, t_max=0.1)
    ipo_kw = dict(iterations=40, keypoint_list=tuple(range(n_joints)), rot_axes="xyz",
                  t_norm=1.0, min_scale_t=0.0, max_scale_t=4.0)
    oil_kw = dict(iterations=steps, track_reproj=True)
    jz = jpipe.ZeDOConfig(ipo=jipo.IPOConfig(**ipo_kw), oil=joil.OILConfig(**oil_kw))
    tz = tpipe.ZeDOConfig(ipo=tipo.IPOConfig(**ipo_kw),
                          oil=toil.OILConfig(**oil_kw, use_kernel=kind == "control" or None))
    want_path = {"plain": "plain", "cond": "generic", "control": "kernel3"}[kind]
    condition = (px / 500.0 - 1.0).astype(np.float32) if kind == "cond" else None
    j_apply = jmod.apply
    if condition is not None:
        def j_apply(p, c, x, labels, cond_arg=None, mask=None, **kw):
            return jmod.apply(p, c, x, labels, jnp.asarray(condition) if cond_arg is None
                              else cond_arg, mask, **kw)
    want = jinf.solve_infant(jparams, j_apply, jcfg, jsde, JPCSampler(sde=jsde, eps=0.01), jz,
                             jnp.asarray(clusters), jnp.asarray(px), jnp.asarray(k),
                             pelvis_mode=mode, precision=jax.lax.Precision.HIGHEST)
    assert toil.model_path(tparams, tcfg, tz.oil, tmod.apply,
                           None if condition is None else torch.zeros(1)) == want_path
    got = tinf.solve_infant(tparams, tmod.apply, tcfg, tsde, TPCSampler(sde=tsde, eps=0.01),
                            tz, torch.from_numpy(clusters), torch.from_numpy(px),
                            torch.from_numpy(k), pelvis_mode=mode,
                            condition=None if condition is None else torch.from_numpy(condition))
    assert got.poses.shape == (5, 2, n_joints, 3) and got.reproj_px.shape == (2, steps)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_TOL,
                               rtol=POSE_RTOL)
    np.testing.assert_allclose(got.translations.numpy(), np.asarray(want.translations),
                               atol=POSE_TOL, rtol=POSE_RTOL)
    np.testing.assert_allclose(got.reproj_px.numpy(), np.asarray(want.reproj_px),
                               rtol=TRACE_RTOL)
    one = tinf.solve_one_hypothesis_infant(
        tparams, tmod.apply, tcfg, tsde, TPCSampler(sde=tsde, eps=0.01), tz,
        torch.from_numpy(clusters[1]), torch.from_numpy(px), torch.from_numpy(k),
        pelvis_mode=mode, condition=None if condition is None else torch.from_numpy(condition))
    torch.testing.assert_close(one.pose, got.poses[:, 1])
    torch.testing.assert_close(one.reproj_px[0], got.reproj_px[1])


# ------------------------------------------------------------------ readers
def _infant_files(rng):
    """The fixtures of tests/test_reference_parity.py::test_infant_reader_parity,
    drawn in its order from its seed, in the working directory."""
    os.makedirs("data/mini-rgbd")
    d = {"train": {}, "validate": {}}
    for split, seq, count in [("train", "01", 6), ("validate", "11", 4)]:
        for i in range(count):
            d[split][f"{seq}_f{i}.txt"] = {
                "pose_2d": rng.rand(25, 2).astype(np.float32) * 400 + 100,
                "pose_3d": rng.randn(25, 3).astype(np.float32) * 0.1,
            }
    np.save("data/mini-rgbd/MINI-RGBD.npy", d)
    os.makedirs("data/syrip/SyRIP_3d_pred")
    os.makedirs("data/syrip/SyRIP_3d_correction")
    n = 6
    names = np.array([f"path/to/img{i:03d}.jpg" for i in range(n)])
    np.save("data/syrip/SyRIP_3d_pred/output_imgnames.npy", names)
    np.save("data/syrip/SyRIP_3d_correction/correct_3D.npy",
            rng.randn(n, 14, 3).astype(np.float32))
    np.save("data/syrip/train_rysip.npy",
            {f"img{i:03d}.jpg": [f"img{i:03d}.jpg", i] for i in range(4)})
    np.save("data/syrip/test_rysip.npy",
            {f"img{i:03d}.jpg": [f"img{i:03d}.jpg", i] for i in range(4, 6)})
    pose2d = {f"img{i:03d}.jpg": {"h": 480, "w": 640, "bbox": [0, 0, 10, 10],
                                  "keypoints": rng.rand(17, 3).astype(np.float32) * 400}
              for i in range(n)}
    np.save("data/syrip/train_pose2d.npy", {k: pose2d[k] for k in list(pose2d)[:4]})
    np.save("data/syrip/test_pose2d.npy", {k: pose2d[k] for k in list(pose2d)[4:]})


MINI_VARIANTS = [dict(subset="train", num_joint=17, abs_coord=True),
                 dict(subset="validate", num_joint=12, abs_coord=False),
                 dict(subset="validate", num_joint=17, normed=True, sample_interval=2)]


def test_infant_readers_match_jax_and_golden(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _infant_files(np.random.RandomState(0))
    with np.load(os.path.join(GOLDEN_DIR, "test_infant_reader_parity.npz")) as z:
        files = {k: z[k] for k in z.files}
    want_mini, want_syrip = _unflatten(files, "mini"), _unflatten(files, "syrip")
    for i, kw in enumerate(MINI_VARIANTS):
        mine = tmini.mini_rgbd(gt2d=True, **kw)
        ref = jdata.mini_rgbd(gt2d=True, **kw)
        for name in ("db_2d", "db_3d", "camera_param", "frame_name"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
        if i < 2:  # the golden's variants
            for name in ("db_2d", "db_3d"):
                np.testing.assert_allclose(getattr(mine, name), want_mini[f"v{i}"][name],
                                           rtol=1e-6)
    for subset in ("train", "validate"):
        mine = tsyrip.syrip(subset=subset, num_joint=12)
        ref = jdata.syrip(subset=subset, num_joint=12)
        for name in ("db_2d", "db_3d", "K", "camera_param", "h", "w", "frame_name"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
        for name in ("db_2d", "db_3d", "K"):
            np.testing.assert_allclose(getattr(mine, name), want_syrip[subset][name], rtol=1e-6)
    with pytest.raises(ValueError, match="num_joint=12 only"):
        tsyrip.syrip(subset="train", num_joint=17)
    # aug=True: the prior-only rows, each shrunk by a draw of the dataset's
    # RandomState, the same for the same state
    rs = np.random.RandomState(4)
    np.save("aug_mini.npy", rs.randn(5, 17, 3).astype(np.float32))
    np.save("cls_aug_data.npy", rs.randn(3, 12, 3).astype(np.float32))
    for mine, ref in ((tmini.mini_rgbd(aug=True, rng=np.random.RandomState(9)),
                       jdata.mini_rgbd(aug=True, rng=np.random.RandomState(9))),
                      (tsyrip.syrip(num_joint=12, aug=True, rng=np.random.RandomState(9)),
                       jdata.syrip(num_joint=12, aug=True, rng=np.random.RandomState(9)))):
        for name in ("db_2d", "db_3d", "camera_param", "frame_name"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
        assert len(mine) == len(ref)
        for idx in (0, len(mine) - 1):
            for a, b in zip(mine[idx], ref[idx]):
                np.testing.assert_array_equal(a, b)
    assert (tmini.SMIL_TO_H36M, tmini.CHANGE_TO_12, tmini.MINI_K) == (
        jmini.SMIL_TO_H36M, jmini.CHANGE_TO_12, jmini.MINI_K)
    assert (tsyrip.CHANGE_2D, tsyrip.CHANGE_12) == (jsyrip.CHANGE_2D, jsyrip.CHANGE_12)
    assert (tsyrip.syrip.left_joints, tsyrip.syrip.right_joints) == (
        jsyrip.syrip.left_joints, jsyrip.syrip.right_joints)


@pytest.mark.parametrize("protocol2", [False, True])
def test_infant_eval_multi_matches_jax(tmp_path, monkeypatch, protocol2):
    """mini at 17 and 12 joints (12: the 7-joint subset before alignment)
    and syrip, on random hypotheses."""
    monkeypatch.chdir(tmp_path)
    _infant_files(np.random.RandomState(0))
    rs = np.random.RandomState(3)
    readers = [(tmini.mini_rgbd, jdata.mini_rgbd, dict(subset="validate", num_joint=n))
               for n in (17, 12)]
    readers.append((tsyrip.syrip, jdata.syrip, dict(subset="validate", num_joint=12)))
    for tcls, jcls, kw in readers:
        mine, ref = tcls(**kw), jcls(**kw)
        preds = rs.randn(len(mine.db_3d), 3, *mine.db_3d.shape[1:]).astype(np.float32) * 0.1
        got = mine.eval_multi(torch.from_numpy(preds), protocol2=protocol2)
        want = ref.eval_multi(preds, protocol2=protocol2)
        assert abs(got - want) <= 1e-5 * abs(want), (kw, got, want)
        got = mine.eval_multi(preds, protocol2=protocol2, sample_interval=2)
        want = ref.eval_multi(preds, protocol2=protocol2, sample_interval=2)
        assert abs(got - want) <= 1e-5 * abs(want), (kw, got, want)


# ------------------------------------------------------------------ presets
def jax_config(name):
    return importlib.import_module(f"configs.optim.concat_pose_optimization_{FILES[name]}") \
        .get_config()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("name", list(FILES))
def test_infant_preset_equals_its_config_file(name):
    jc = jax_config(name)
    flat = _flat(presets.optim_config(name))
    for path, value in flat.items():
        if path.split(".")[-1] in ("hidden_dim", "embed_dim", "n_blocks"):
            continue
        node = jc
        for p in path.split("."):
            assert p in node, path
            node = node[p]
        assert value == node and type(value) is type(node), (path, value, node)
    n_joints = {"mini": 17, "syrip": 12}[name]
    assert flat["DATASET.NUM_JOINT"] == jc.DATASET.NUM_JOINT == n_joints
    preset = presets.from_optim_config(presets.optim_config(name))
    with jc.unlocked():
        jc.model.hidden_dim, jc.model.embed_dim = 1024, 512
    assert preset.model_cfg.n_joints == n_joints
    assert preset.model_cfg == tsm.ScoreMLPConfig(
        **{f: getattr(j_make_mlp_config(jc, n_joints=n_joints), f)
           for f in tsm.ScoreMLPConfig.__dataclass_fields__})
    assert preset.sampler.probability_flow and preset.zcfg.ipo.rot_axes == "xyz"
    assert preset.zcfg.ipo.keypoint_list == tuple(range(n_joints))


# ---------------------------------------------------------------------- CLI
def _workspace(dataset, kind, root):
    """A small synthetic workspace of the dataset, and a .pth of `kind`
    (hidden 128) with the prior's output scaled down."""
    rng = np.random.RandomState(0)
    if dataset == "mini":
        smoke().write_mini_workspace(str(root), rng, 6, hypo=2)
    else:
        smoke().write_syrip_workspace(str(root), rng, 5)
    n_joints = 17 if dataset == "mini" else 12
    _, _, _, _, _, tparams = models(kind, n_joints)
    os.makedirs(root / "checkpoint")
    smoke().save_pth(torch, tparams, str(root / "checkpoint" / "m.pth"))


def _trace(printed):
    line = next(x for x in printed.splitlines() if x.startswith("reprojection error"))
    return [float(v) for v in re.findall(r"step \d+: ([0-9.]+)px", line)]


def _jax_cli(dataset, kind, monkeypatch, save, hypo=2, dtype="fp32", config=None,
             ckpt=("checkpoint", "m.pth")):
    import zedo_tpu.run.opt_main_infant as jcli

    if config is None:
        config = jax_config(dataset)
        config.ZeDO.IPO_iterations = config.ZeDO.OIL_iterations = 20
        with config.unlocked():
            config.model.hidden_dim, config.model.embed_dim = 128, 64
    monkeypatch.setattr(jcli, "FLAGS", types.SimpleNamespace(config=config))
    jcli.main(types.SimpleNamespace(
        ckpt_dir=ckpt[0], ckpt_name=ckpt[1], gt=True, hypo=hypo,
        control=kind == "control", cond=kind == "cond", dtype=dtype, seed=0,
        cluster_path=None, save=save, override=[]))


@pytest.mark.parametrize("dataset", ["mini", "syrip"])
@pytest.mark.parametrize("kind", ["plain", "control", "cond"])
def test_cli_matches_jax(dataset, kind, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _workspace(dataset, kind, tmp_path)
    flags = {"plain": [], "control": ["--control"], "cond": ["--cond"]}[kind]
    argv = ["--config", dataset, "--device", "cpu", "--ckpt_dir", "checkpoint", "--ckpt_name",
            "m.pth", "--hypo", "2", "--dtype", "fp32", "--save", "port.npy", *flags]
    for o in SMALL + SHORT:
        argv += ["--override", o]
    out = tcli.main(argv)
    printed = capsys.readouterr().out
    _jax_cli(dataset, kind, monkeypatch, "jax.npy")
    jprinted = capsys.readouterr().out
    n, j = (6, 17) if dataset == "mini" else (5, 12)
    saved, want = np.load("port.npy"), np.load("jax.npy")
    assert saved.shape == want.shape == (n, 2, j, 3)
    np.testing.assert_array_equal(saved, out["poses"].numpy())
    np.testing.assert_allclose(saved, want, atol=POSE_TOL, rtol=POSE_RTOL)
    assert out["reproj_px"].shape == (2, 20)
    np.testing.assert_allclose(_trace(printed), _trace(jprinted), rtol=TRACE_RTOL, atol=0.011)
    assert f"solved {n} poses x 2 hypotheses x 20 OIL steps" in printed
    assert "max bone length (final poses)" in printed and "mean MPJPE error" in printed
    assert min(out[k] for k in ("solve_s", "ipo_s", "oil_s", "eval_s")) > 0


def test_cli_errors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=r"mini, syrip"):
        tcli.main(["--config", "h36m", "--device", "cpu"])
    # an adult file is read, as the JAX CLI reads it, and its dataset refused
    # by the infant readers as there
    with pytest.raises(ValueError, match="h36m"):
        tcli.main(["--config", os.path.join(REPO, "configs", "optim",
                                            "concat_pose_optimization_h36m.py"),
                   "--device", "cpu"])
    path = os.path.join(REPO, "configs", "optim", "concat_pose_optimization_syrip.py")
    flat = _flat(tcli.load_config(path, tcli.PRESETS))
    assert flat == _flat(jax_config("syrip").to_dict())
    assert all(flat[k] == v for k, v in _flat(presets.optim_config("syrip")).items()
               if k.split(".")[-1] not in ("hidden_dim", "embed_dim", "n_blocks"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--config", "mini"])


def test_chip_smoke_infant_reference(tmp_path, monkeypatch):
    """chip_smoke.py holds the infant CLI on the card to the JAX CLI's MPJPE
    on the trained fixture as MINI-RGBD frames at the full schedule;
    recompute those values."""
    sm = smoke()
    from zedo_tpu_torch import bench_trained as tbt

    monkeypatch.chdir(tmp_path)
    sm.write_infant_fixture_workspace(str(tmp_path), tbt)
    assert set(sm.JAX_INFANT_FIXTURE_MPJPE_MM) == {"fp32", "bf16"}
    for dtype, want in sm.JAX_INFANT_FIXTURE_MPJPE_MM.items():
        config = jax_config("mini")
        with config.unlocked():
            config.model.hidden_dim, config.model.embed_dim = 256, 128
        save = str(tmp_path / f"{dtype}.npy")
        _jax_cli("mini", "plain", monkeypatch, save, hypo=sm.INFANT_FIXTURE_HYPO, dtype=dtype,
                 config=config, ckpt=(os.path.join(tbt.FIXTURE, "checkpoint"),
                                      "checkpoint_trained.pth"))
        got = jdata.mini_rgbd("validate", gt2d=True, read_confidence=False,
                              sample_interval=1, num_joint=17).eval_multi(np.load(save)) * 1000
        assert abs(got - want) < 1e-2, (dtype, got)


def test_chip_smoke_infant_fixture_is_well_conditioned(tmp_path, monkeypatch):
    """The infant pipeline runs IPO with all three rotation axes, which is
    chaotic from a far init: the packages' f32 rounding moves the fixture's
    MPJPE by millimetres there. chip_smoke.py's fixture frames (the first
    frame's pose as the cluster, the poses at 3.5 m) are chosen where it
    does not: 1e-4 px of noise on the 2D keypoints moves the MPJPE by far
    less than the 1 mm the card is held to (spread below 0.35 mm)."""
    from zedo_tpu_torch import bench_trained as tbt
    from zedo_tpu_torch.utils.checkpoint import load_any_checkpoint

    sm = smoke()
    monkeypatch.chdir(tmp_path)
    sm.write_infant_fixture_workspace(str(tmp_path), tbt)
    data = tmini.mini_rgbd("validate", gt2d=True, read_confidence=False, sample_interval=1,
                           num_joint=17)
    cluster = np.load(f"mini_cluster_{sm.INFANT_FIXTURE_HYPO}.npy")[0][tmini.SMIL_TO_H36M]
    config = tconfig.apply_overrides(presets.optim_config("mini"),
                                     ["model.hidden_dim=256", "model.embed_dim=128"])
    preset = presets.from_optim_config(config)
    params, _ = load_any_checkpoint(tbt.CHECKPOINT, preset.model_cfg, device="cpu")
    k = torch.from_numpy(np.tile(tmini.mini_intrinsics(), (len(data), 1, 1)))
    mm = []
    # four full-schedule solves of small ops: on one thread they do not spin
    # against the other test workers (with torch's default threads they ran
    # 40x slower under the parallel test run)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in range(4):
            noise = np.random.RandomState(seed).randn(*data.db_2d.shape) * 1e-4 * (seed > 0)
            res = tinf.solve_infant(params, tsm.apply, preset.model_cfg, preset.sde,
                                    preset.sampler, preset.zcfg, torch.from_numpy(cluster[None]),
                                    torch.from_numpy((data.db_2d + noise).astype(np.float32)), k)
            mm.append(data.eval_multi(res.poses) * 1000)
    finally:
        torch.set_num_threads(threads)
    print("MPJPE under 1e-4 px of noise (mm):", mm, "spread (std):", np.std(mm))
    assert np.std(mm) < 0.35, mm
    assert abs(mm[0] - sm.JAX_INFANT_FIXTURE_MPJPE_MM["fp32"]) < 1.0
