"""zedo_tpu_torch's data/prep converters, data/sharding.contiguous_chunks and
parallel.mesh against the JAX package's, the process-group bring-up, the
ported two-process checks and the batch CLI launched as two Gloo ranks.

Prep outputs, chunks, mesh outcomes (None, the axis sizes or the same
ValueError text) and the tensor-parallel rule of every leaf are held equal.
The two-rank CLI's poses equal its one-process run's within the tolerance
test_torch_pipeline.py holds the solve to (1e-4 m absolute, 1e-3 relative;
IPO's loss is a mean over each rank's own rows). Each multi-process run has
a timeout of 120 s."""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from zedo_tpu.data import sharding as jsharding
from zedo_tpu.data.prep import mini_process as jmini
from zedo_tpu.data.prep import syrip_process as jsyrip
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.parallel import mesh as jmesh
from zedo_tpu_torch.data import sharding as tsharding
from zedo_tpu_torch.data.prep import mini_process as tmini
from zedo_tpu_torch.data.prep import syrip_process as tsyrip
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models.nn import tree_to_flat
from zedo_tpu_torch.parallel import mesh as tmesh
from zedo_tpu_torch.parallel import multiprocess_check as mpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(a, b, path="out"):
    """Equal nested dicts / lists / arrays, types and dtypes included."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for key in a:
            assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _mini_raw(root, rs):
    """Sequences 01 (train), 11 (validate) and 13 (skipped), two frames each,
    25 joint lines (2D with depth, 3D) and a short trailing line."""
    for seq in ("01", "11", "13"):
        os.makedirs(root / seq / "joints_2Ddep")
        os.makedirs(root / seq / "joints_3D")
        for fr in range(2):
            with open(root / seq / "joints_2Ddep" / f"syn_joints_2Ddep_{fr:05d}.txt", "w") as f:
                for x in rs.rand(25, 3) * 500:
                    f.write(" ".join(f"{v:.3f}" for v in x) + "\n")
                f.write("7\n")
            with open(root / seq / "joints_3D" / f"syn_joints_3D_{fr:05d}.txt", "w") as f:
                for x in rs.randn(25, 3):
                    f.write(" ".join(f"{v:.4f}" for v in x) + "\n")


def _coco(rs, names):
    return {"images": [{"file_name": n, "height": 480 + i, "width": 640 - i}
                       for i, n in enumerate(names)],
            "annotations": [{"bbox": [float(v) for v in rs.rand(4)],
                             "keypoints": [int(v) for v in rs.randint(0, 600, 36)]}
                            for _ in names]}


def _syrip_raw(root, rs):
    (root / "SyRIP_2d_gt" / "train200").mkdir(parents=True)
    (root / "SyRIP_2d_gt" / "validate500").mkdir(parents=True)
    (root / "survey_data").mkdir()
    names = [f"real_{i:04d}.jpg" for i in range(6)]
    with open(root / "SyRIP_2d_gt/train200/person_keypoints_train_infant.json", "w") as f:
        json.dump(_coco(rs, ["images/" + n for n in names[:3]]), f)
    np.save(root / "survey_data/img_name700_map.npy",
            np.array([[f"s{i}.jpg", n] for i, n in enumerate(names)]))
    for split, count in (("validate", 4), ("train", 5)):
        with open(root / f"SyRIP_2d_gt/validate500/person_keypoints_{split}_infant.json",
                  "w") as f:
            json.dump(_coco(rs, [f"{split}_{i}.jpg" for i in range(count)]), f)


def test_mini_process_matches_jax(tmp_path):
    _mini_raw(tmp_path / "raw", np.random.RandomState(0))
    want = jmini.process(str(tmp_path / "raw"), str(tmp_path / "jax.npy"))
    got = tmini.process(str(tmp_path / "raw"), str(tmp_path / "port.npy"))
    assert_same(got, want)
    assert_same(np.load(tmp_path / "port.npy", allow_pickle=True).item(),
                np.load(tmp_path / "jax.npy", allow_pickle=True).item())
    assert len(got["train"]) == len(got["validate"]) == 2


def test_syrip_process_matches_jax(tmp_path):
    _syrip_raw(tmp_path, np.random.RandomState(1))
    for name, module in (("jax", jsyrip), ("port", tsyrip)):
        (tmp_path / name).mkdir()
        module.process(str(tmp_path), str(tmp_path / name))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "test_pose2d.npy", "test_rysip.npy", "train_pose2d.npy", "train_rysip.npy"]
    for f in files:
        assert_same(np.load(tmp_path / "port" / f, allow_pickle=True).item(),
                    np.load(tmp_path / "jax" / f, allow_pickle=True).item(), f)


def test_prep_cli_usage(tmp_path):
    _mini_raw(tmp_path / "raw", np.random.RandomState(2))
    out = tmp_path / "m.npy"
    subprocess.run([sys.executable, "-m", "zedo_tpu_torch.data.prep.mini_process",
                    str(tmp_path / "raw"), str(out)], check=True, cwd=REPO, timeout=120)
    assert_same(np.load(out, allow_pickle=True).item(),
                jmini.process(str(tmp_path / "raw"), str(tmp_path / "j.npy")))


@pytest.mark.parametrize("n,shards", [(10, 4), (7, 7), (3, 5), (886, 8), (0, 2)])
def test_contiguous_chunks_match_jax(n, shards):
    got, want = tsharding.contiguous_chunks(n, shards), jsharding.contiguous_chunks(n, shards)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)


SPECS = ["auto", "off", "none", "single", "1", None, " DP ", "dp", "dp1", "dp2", "dp4", "dp8",
         "dp,tp2", "dp2,tp2", "dp1,tp2", "dp4,tp2", "dp,tp4", "dp3", "dp0", "dp,tp0", "dp2,tp0",
         "tp2", "dp2,", "bogus"]


def _outcome(build, spec, devices):
    try:
        m = build(spec, devices)
    except ValueError as e:
        return "error", str(e)
    if m is None:
        return None
    return dict(m.shape), [int(getattr(d, "id", d)) for d in np.asarray(m.devices).ravel()]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_from_spec_matches_jax(world):
    """The outcome of every spec on `world` devices (JAX: the first `world`
    virtual CPU devices, whose ids are 0..world-1; the port: ranks)."""
    jdevs = jax.devices()[:world]
    for spec in SPECS:
        want = _outcome(lambda s, d: jmesh.mesh_from_spec(s, d), spec, jdevs)
        got = _outcome(lambda s, d: tmesh.mesh_from_spec(s, d, device="cpu"), spec,
                       list(range(world)))
        assert got == want, (spec, world)


def test_default_mesh_matches_jax():
    jdevs = jax.devices()[:8]
    for tp in (1, 2, 4):
        want = jmesh.default_mesh(jdevs, model_axis="model", model_parallel=tp)
        got = tmesh.default_mesh(list(range(8)), model_axis="model", model_parallel=tp,
                                 device="cpu")
        assert dict(got.shape) == dict(want.shape)
        np.testing.assert_array_equal(got.devices, np.vectorize(lambda d: d.id)(want.devices))
    with pytest.raises(ValueError):
        tmesh.default_mesh(list(range(6)), model_axis="model", model_parallel=4)


@pytest.mark.parametrize("kw", [dict(hidden_dim=128, embed_dim=64),
                                dict(hidden_dim=256, embed_dim=128, embedding_type="fourier"),
                                dict(hidden_dim=64, embed_dim=64, n_blocks=1)])
def test_tp_rule_matches_jax_tp_shardings(kw):
    """Leaf by leaf: P('model', None) and P('model') are 'row', P(None,
    'model') is 'col', P() is 'replicated' (embed == hidden makes the time
    layers row-sharded too, as in JAX)."""
    jcfg, tcfg = jsm.ScoreMLPConfig(**kw), tsm.ScoreMLPConfig(**kw)
    jparams = jsm.init_params(jax.random.PRNGKey(0), jcfg)
    jmesh_ = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    specs = jax.tree_util.tree_flatten_with_path(jmesh.tp_shardings(jmesh_, jparams))[0]
    names = {".".join(str(getattr(k, "key", k)) for k in path): s.spec for path, s in specs}
    rule = {("model", None): "row", ("model",): "row", (None, "model"): "col", (): "replicated"}
    got = tree_to_flat(tmesh.tp_shardings(tsm.init_params(torch.Generator(), tcfg,
                                                          device="cpu")))
    assert got == {n: rule[tuple(spec)] for n, spec in names.items()}


def test_backend_and_device_errors():
    """No fallback: an unknown backend and NCCL on the CPU raise before any
    process group is created; a rank outside a mesh raises."""
    with pytest.raises(ValueError, match="backend 'mpi'"):
        tmesh.init_distributed(backend="mpi", rank=0, world_size=1, device="cpu")
    with pytest.raises(ValueError, match="NCCL takes CUDA tensors only"):
        tmesh.init_distributed(backend="nccl", rank=0, world_size=1, device="cpu")
    mesh = tmesh.Mesh(np.array([3, 4]), ("data",), device="cpu")  # rank 0 is not in it
    with pytest.raises(ValueError, match="outside the mesh"):
        mesh.row_slice(4)


CHILD_BRINGUP = r"""
import torch
import torch.distributed as dist
from zedo_tpu_torch.parallel import collectives, mesh as mesh_lib
dev = mesh_lib.init_distributed(device="cpu")  # torchrun's environment, world size 1
assert dist.get_world_size() == 1 and dist.get_backend() == "gloo" and dev.type == "cpu"
mesh = mesh_lib.default_mesh(device="cpu")
assert mesh.shape == {"data": 1} and mesh.is_main and mesh.group is dist.group.WORLD
x = torch.arange(8.0)
assert torch.equal(collectives.all_gather(x, mesh), x)
assert float(collectives.pmean(x, mesh).sum()) == 28.0
assert collectives.broadcast_object("stamp", mesh) == "stamp"
assert torch.equal(collectives.broadcast(x, mesh), x)
assert torch.equal(collectives.psum(x, mesh), x)
assert mesh_lib.mesh_from_spec("auto", device="cpu") is None
dist.destroy_process_group()
print("RESULT init_distributed OK")
"""


def test_init_distributed_single_process():
    out = mpc.run_ranks(["-c", CHILD_BRINGUP], 1, timeout=120)
    assert "RESULT init_distributed OK" in out[0]


def test_two_process_evidence():
    lines = mpc.two_process_evidence(timeout=120)
    assert "replicas bit-identical" in lines[0] and "ok=True" in lines[1]


def test_run_ranks_reports_a_failed_rank_and_stops_its_peer():
    """A rank that fails is reported with its error; its peer, waiting in a
    collective for it, is killed instead of hanging to the timeout."""
    child = ("import sys, torch, torch.distributed as dist\n"
             "from zedo_tpu_torch.parallel import mesh\n"
             "mesh.init_distributed(device='cpu')\n"
             "if dist.get_rank() == 1: sys.exit('rank 1 gives up')\n"
             "dist.all_reduce(torch.ones(1))\n")
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        mpc.run_ranks(["-c", child], 2, timeout=120)


def test_opt_main_cli_on_two_ranks_matches_one_process(tmp_path):
    """run.opt_main as two Gloo ranks (torchrun's environment) on the trained
    fixture: 24 poses, 12 a rank, gathered; rank 0 saves and prints the
    result and the tables, the other rank neither."""
    fx = os.path.join(REPO, "tests", "fixtures", "trained")
    args = ["-m", "zedo_tpu_torch.run.opt_main", "--config", "h36m", "--device", "cpu",
            "--ckpt_dir", os.path.join(fx, "checkpoint"),
            "--ckpt_name", "checkpoint_trained.pth", "--cluster_dir", os.path.join(fx, "clusters"),
            "--data_dir", os.path.join(fx, "data"), "--gt", "--hypo", "2",
            "--override", "model.hidden_dim=256", "--override", "model.embed_dim=128",
            "--override", "ZeDO.sample=1", "--override", "ZeDO.IPO_iterations=60",
            "--override", "ZeDO.OIL_iterations=40"]
    outs = mpc.run_ranks(args + ["--save", str(tmp_path / "mesh.npy")], 2, timeout=120,
                         env={"OMP_NUM_THREADS": "2"})
    assert "on 2 device(s)" in outs[0] and "eval..." in outs[0]
    assert "solved" not in outs[1] and "eval..." not in outs[1]
    one = mpc.run_ranks(args + ["--save", str(tmp_path / "one.npy")], 1, timeout=120)
    assert "on 1 device(s)" in one[0]
    mesh_poses, one_poses = np.load(tmp_path / "mesh.npy"), np.load(tmp_path / "one.npy")
    assert mesh_poses.shape == (24, 2, 17, 3)
    np.testing.assert_allclose(mesh_poses, one_poses, atol=1e-4, rtol=1e-3)


def test_opt_main_infant_cli_on_two_ranks_matches_one_process(tmp_path):
    """run.opt_main_infant as two Gloo ranks on the trained fixture's poses as
    MINI-RGBD frames: 24 frames, 12 a rank, the trace averaged over the
    ranks; rank 0 prints the trace and saves."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from zedo_tpu_torch import bench_trained

    chip_smoke.write_infant_fixture_workspace(str(tmp_path), bench_trained)
    fx = os.path.join(REPO, "tests", "fixtures", "trained")
    args = ["-m", "zedo_tpu_torch.run.opt_main_infant", "--config", "mini", "--device", "cpu",
            "--hypo", "1", "--ckpt_dir", os.path.join(fx, "checkpoint"),
            "--ckpt_name", "checkpoint_trained.pth", "--override", "model.hidden_dim=256",
            "--override", "model.embed_dim=128", "--override", "ZeDO.IPO_iterations=60",
            "--override", "ZeDO.OIL_iterations=40"]
    outs = mpc.run_ranks(args + ["--save", "mesh.npy"], 2, timeout=120, cwd=str(tmp_path),
                         env={"OMP_NUM_THREADS": "2"})
    assert "on 2 device(s)" in outs[0] and "reprojection error" in outs[0]
    assert "solved" not in outs[1] and "reprojection error" not in outs[1]
    one = mpc.run_ranks(args + ["--save", "one.npy"], 1, timeout=120, cwd=str(tmp_path))

    def trace(out):  # the printed "step i: x.xxpx" values
        line = next(x for x in out.splitlines() if x.startswith("reprojection error"))
        return [float(v) for v in re.findall(r": ([0-9.]+)px", line)]

    assert len(trace(outs[0])) == 5
    np.testing.assert_allclose(trace(outs[0]), trace(one[0]), atol=0.02)
    mesh_poses, one_poses = np.load(tmp_path / "mesh.npy"), np.load(tmp_path / "one.npy")
    assert mesh_poses.shape == (24, 1, 17, 3)
    np.testing.assert_allclose(mesh_poses, one_poses, atol=1e-4, rtol=1e-3)
