"""zedo_tpu_torch's sharded solves and serving mesh on two Gloo ranks on the
CPU (parallel/, pipeline.solve_sharded, infant.solve_infant_sharded,
ZeDOEstimator(mesh=...)) against the JAX package's shard_map solves on a
2-device mesh of the 8 virtual CPU devices.

One two-rank run (a timeout of 120 s) computes every port result of this
file; the tests read its files. Tolerances: the poses and translations
those test_torch_pipeline.py holds pipeline.solve to (1e-4 m absolute,
1e-3 relative), the reprojection trace 1e-3 relative; each rank's rows
equal, bit for bit, `solve` on its block alone; the serving mesh within
1e-4 m of the one-device predict (IPO's loss is a mean over each rank's own
rows, as in JAX's shard_map)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from zedo_tpu import bench_trained as jbt
from zedo_tpu.data import sharding as jsharding
from zedo_tpu.diffusion.sampling import PCSampler as JPCSampler
from zedo_tpu.diffusion.sde import SubVPSDE as JSubVPSDE
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.models import score_mlp_cond as jcond
from zedo_tpu.zeroshot import infant as jinf
from zedo_tpu.zeroshot import ipo as jipo
from zedo_tpu.zeroshot import oil as joil
from zedo_tpu.zeroshot import pipeline as jpipe
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch.parallel import multiprocess_check as mpc
from zedo_tpu_torch.parallel.mesh import Mesh, mesh_from_spec
from zedo_tpu_torch.serving import ZeDOEstimator

POSE_TOL, POSE_RTOL, TRACE_RTOL = 1e-4, 1e-3, 1e-3
N, N_PAD, S, IPO_ITERS, OIL_ITERS = 8, 7, 2, 60, 25
INFANT_N, INFANT_STEPS = 6, 30
SERVE_N, SERVE_BUCKET = 10, 8

CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from zedo_tpu_torch.parallel import mesh as mesh_lib
mesh_lib.init_distributed(device="cpu")
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch.data.sharding import pad_batch
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp, score_mlp_cond
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.utils.checkpoint import params_from_numpy
from zedo_tpu_torch.zeroshot import infant, ipo, oil, pipeline

inp = np.load(sys.argv[1] + "/inputs.npy", allow_pickle=True).item()
N, N_PAD, S, IPO_ITERS, OIL_ITERS, INFANT_STEPS = (
    inp["N"], inp["N_PAD"], inp["S"], inp["IPO"], inp["OIL"], inp["INFANT_STEPS"])
mesh = mesh_lib.default_mesh(device="cpu")
rank = dist.get_rank()
out = {}

def same(name, a, b):
    out[name + "_bitwise"] = bool(torch.equal(a, b))

tcfg, tparams, family = tbt.load_fixture(device="cpu")
sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=OIL_ITERS, t_max=0.1)
sampler = PCSampler(sde=sde, eps=0.01)
px, k, clusters = (torch.from_numpy(inp[x]) for x in ("px", "k", "clusters"))

def zcfg(track):
    return pipeline.ZeDOConfig(ipo=ipo.IPOConfig(iterations=IPO_ITERS),
                               oil=oil.OILConfig(iterations=OIL_ITERS, track_reproj=track))

with torch.no_grad():
    # the adult solve: the gathered result, and this rank's block alone
    res = pipeline.solve_sharded(mesh, tparams, tcfg, sde, sampler, zcfg(False), clusters,
                                 px, None, k)
    rows = mesh.row_slice(N)
    alone = pipeline.solve(tparams, tcfg, sde, sampler, zcfg(False), clusters, px[rows],
                           None, k[rows])
    same("adult_poses", res.poses[rows], alone.poses)
    same("adult_trans", res.translations[rows], alone.translations)
    out["adult_poses"], out["adult_trans"] = res.poses.numpy(), res.translations.numpy()
    whole = pipeline.solve(tparams, tcfg, sde, sampler, zcfg(False), clusters, px, None, k)
    out["adult_whole_maxdiff"] = float((whole.poses - res.poses).abs().max())

    # a padded batch with the trace: pad rows out of the trace's mean
    padded, mask = pad_batch({"px": inp["px"][:N_PAD], "k": inp["k"][:N_PAD]}, 2)
    res = pipeline.solve_sharded(mesh, tparams, tcfg, sde, sampler, zcfg(True), clusters,
                                 padded["px"], None, padded["k"], row_mask=mask)
    out["pad_poses"], out["pad_trace"] = res.poses[:N_PAD].numpy(), res.reproj_px.numpy()
    rows = mesh.row_slice(len(mask))
    w = torch.from_numpy(mask * np.float32(2 / mask.sum()))
    alone = pipeline.solve(tparams, tcfg, sde, sampler, zcfg(True), clusters,
                           torch.from_numpy(padded["px"][rows]), None,
                           torch.from_numpy(padded["k"][rows]), reproj_weight=w[rows])
    same("pad_poses", res.poses[rows], alone.poses)
    out["pad_chunk_trace"] = alone.reproj_px.numpy()

    # the infant solve, plain and conditional
    ipo_kw = dict(iterations=40, keypoint_list=tuple(range(17)), rot_axes="xyz", t_norm=1.0,
                  min_scale_t=0.0, max_scale_t=4.0)
    izcfg = pipeline.ZeDOConfig(ipo=ipo.IPOConfig(**ipo_kw),
                                oil=oil.OILConfig(iterations=INFANT_STEPS, track_reproj=True))
    isde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=INFANT_STEPS, t_max=0.1)
    isampler = PCSampler(sde=isde, eps=0.01)
    icfg = score_mlp.ScoreMLPConfig(n_joints=17, hidden_dim=128, embed_dim=64)
    ipx, ik, iclusters = (torch.from_numpy(inp[x]) for x in ("ipx", "ik", "iclusters"))
    rows = mesh.row_slice(len(ipx))
    for kind, apply, condition in (
            ("plain", score_mlp.apply, None),
            ("cond", score_mlp_cond.apply, torch.from_numpy(inp["condition"]))):
        params = params_from_numpy(inp[kind + "_params"], device="cpu")
        gen = torch.Generator().manual_seed(0)
        res = infant.solve_infant_sharded(mesh, params, apply, icfg, isde, isampler, izcfg,
                                          iclusters, ipx, ik, generator=gen,
                                          condition=condition)
        alone = infant.solve_infant(params, apply, icfg, isde, isampler, izcfg, iclusters,
                                    ipx[rows], ik[rows],
                                    generator=torch.Generator().manual_seed(0),
                                    condition=None if condition is None else condition[rows])
        same("infant_" + kind, res.poses[rows], alone.poses)
        out["infant_" + kind], out["infant_trace_" + kind] = res.poses.numpy(), res.reproj_px.numpy()

    # serving: the same request on every rank, against one device
    kw = dict(params=tparams, model_cfg=tcfg, sde=sde, sampler=sampler, zcfg=zcfg(False),
              clusters=inp["clusters"], device=torch.device("cpu"),
              batch_bucket=inp["SERVE_BUCKET"])
    served = ZeDOEstimator(mesh="dp2", **kw).predict(inp["spx"], inp["sk"])
    single = ZeDOEstimator(**kw).predict(inp["spx"], inp["sk"])
    for key in ("poses", "best", "reprojection_error"):
        out["serve_" + key], out["single_" + key] = served[key], single[key]
np.savez(f"{sys.argv[1]}/out{rank}.npz", **out)
print("RESULT ok")
dist.destroy_process_group()
"""


def _infant_scene(rs, n):
    """Infant-sized poses at 1 m before a Kinect-like camera and two cluster
    poses near them, the scenes of test_torch_infant.py (IPO with three
    rotation axes from a far init turns f32 rounding into millimetres in
    either package)."""
    from zedo_tpu_torch.data.mini_rgbd import mini_intrinsics

    pose = rs.randn(17, 3) * 0.1 + rs.randn(n, 17, 3) * 0.01
    pose -= pose[:, :1]
    cam = (pose + np.array([0.05, 0.02, 1.0]) + rs.randn(n, 1, 3) * 0.02).astype(np.float32)
    k = mini_intrinsics()
    px = (cam[..., :2] / cam[..., 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]])
    rel = cam[0] - cam[0, :1]
    clusters = np.stack([rel, rel + rs.randn(*rel.shape) * 0.01]).astype(np.float32)
    return px.astype(np.float32), np.tile(k, (n, 1, 1)).astype(np.float32), clusters


def _jax_params(module, seed):
    cfg = jsm.ScoreMLPConfig(n_joints=17, hidden_dim=128, embed_dim=64)
    params = module.init_params(jax.random.PRNGKey(seed), cfg)
    # a random prior at full output scale throws the poses metres away
    params["post_dense"] = jax.tree.map(lambda a: a * 0.05, params["post_dense"])
    return cfg, params


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("solve2")
    _, _, family = jbt.load_fixture()
    _, k, px = tbt.make_scenes(family, N)
    clusters = tbt.make_hypothesis_clusters(family, S)
    _, sk, spx = tbt.make_scenes(family, SERVE_N, seed=3)
    ipx, ik, iclusters = _infant_scene(np.random.RandomState(0), INFANT_N)
    jparams = {"plain": _jax_params(jsm, 1), "cond": _jax_params(jcond, 2)}
    inputs = dict(N=N, N_PAD=N_PAD, S=S, IPO=IPO_ITERS, OIL=OIL_ITERS,
                  INFANT_STEPS=INFANT_STEPS, SERVE_BUCKET=SERVE_BUCKET, px=px, k=k,
                  clusters=clusters, ipx=ipx, ik=ik, iclusters=iclusters, spx=spx, sk=sk,
                  condition=(ipx / 500.0 - 1.0).astype(np.float32),
                  **{f"{kind}_params": jax.tree.map(np.asarray, p)
                     for kind, (_, p) in jparams.items()})
    np.save(d / "inputs.npy", inputs, allow_pickle=True)
    mpc.run_ranks(["-c", CHILD, str(d)], 2, timeout=120, env={"OMP_NUM_THREADS": "2"})
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(2)]
    return inputs, jparams, outs


def _jmesh():
    return JMesh(np.array(jax.devices()[:2]), ("data",))


def _jax_adult(inputs, track, px, k, row_mask=None):
    jcfg, jparams, _ = jbt.load_fixture()
    sde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=OIL_ITERS, t_max=0.1)
    zcfg = jpipe.ZeDOConfig(ipo=jipo.IPOConfig(iterations=IPO_ITERS),
                            oil=joil.OILConfig(iterations=OIL_ITERS, track_reproj=track))
    return jpipe.solve_sharded(_jmesh(), jparams, jcfg, sde, JPCSampler(sde=sde, eps=0.01),
                               zcfg, jnp.asarray(inputs["clusters"]), jnp.asarray(px), None,
                               jnp.asarray(k), precision=jax.lax.Precision.HIGHEST,
                               row_mask=row_mask)


def test_both_ranks_hold_one_global_result(run):
    _, _, outs = run
    for key in outs[0]:
        if key != "pad_chunk_trace":  # each rank's own block, solved alone
            np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)


def test_each_rank_equals_solve_on_its_block_bitwise(run):
    _, _, outs = run
    for out in outs:
        flags = {k: bool(v) for k, v in out.items() if k.endswith("_bitwise")}
        assert len(flags) == 5 and all(flags.values()), flags


def test_solve_sharded_matches_jax(run):
    inputs, _, outs = run
    want = _jax_adult(inputs, False, inputs["px"], inputs["k"])
    assert outs[0]["adult_poses"].shape == (N, S, 17, 3)
    np.testing.assert_allclose(outs[0]["adult_poses"], np.asarray(want.poses),
                               atol=POSE_TOL, rtol=POSE_RTOL)
    np.testing.assert_allclose(outs[0]["adult_trans"], np.asarray(want.translations),
                               atol=POSE_TOL, rtol=POSE_RTOL)
    # against the whole batch solved at once only IPO's per-rank mean differs
    assert outs[0]["adult_whole_maxdiff"] < 1e-3


def test_solve_sharded_padded_with_trace_matches_jax(run):
    inputs, _, outs = run
    padded, mask = jsharding.pad_batch({"px": inputs["px"][:N_PAD], "k": inputs["k"][:N_PAD]},
                                       2)
    want = _jax_adult(inputs, True, padded["px"], padded["k"], row_mask=mask)
    np.testing.assert_allclose(outs[0]["pad_poses"], np.asarray(want.poses)[:N_PAD],
                               atol=POSE_TOL, rtol=POSE_RTOL)
    np.testing.assert_allclose(outs[0]["pad_trace"], np.asarray(want.reproj_px),
                               rtol=TRACE_RTOL)
    # the trace is the mean of the two blocks' weighted traces solved alone
    chunks = np.stack([o["pad_chunk_trace"] for o in outs])
    np.testing.assert_allclose(outs[0]["pad_trace"], chunks.mean(0), rtol=1e-6)


@pytest.mark.parametrize("kind", ["plain", "cond"])
def test_solve_infant_sharded_matches_jax(run, kind):
    inputs, jparams, outs = run
    jcfg, params = jparams[kind]
    sde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=INFANT_STEPS, t_max=0.1)
    ipo_kw = dict(iterations=40, keypoint_list=tuple(range(17)), rot_axes="xyz", t_norm=1.0,
                  min_scale_t=0.0, max_scale_t=4.0)
    zcfg = jpipe.ZeDOConfig(ipo=jipo.IPOConfig(**ipo_kw),
                            oil=joil.OILConfig(iterations=INFANT_STEPS, track_reproj=True))
    module = {"plain": jsm, "cond": jcond}[kind]
    want = jinf.solve_infant_sharded(
        _jmesh(), params, module.apply, jcfg, sde, JPCSampler(sde=sde, eps=0.01), zcfg,
        jnp.asarray(inputs["iclusters"]), jnp.asarray(inputs["ipx"]), jnp.asarray(inputs["ik"]),
        precision=jax.lax.Precision.HIGHEST,
        condition=jnp.asarray(inputs["condition"]) if kind == "cond" else None)
    np.testing.assert_allclose(outs[0]["infant_" + kind], np.asarray(want.poses),
                               atol=POSE_TOL, rtol=POSE_RTOL)
    np.testing.assert_allclose(outs[0]["infant_trace_" + kind], np.asarray(want.reproj_px),
                               rtol=TRACE_RTOL)


def test_serving_mesh_matches_one_device(run):
    _, _, outs = run
    out = outs[0]
    assert out["serve_poses"].shape == (SERVE_N, S, 17, 3)
    np.testing.assert_allclose(out["serve_poses"], out["single_poses"], atol=1e-4)
    np.testing.assert_array_equal(out["serve_best"], out["single_best"])


def test_serving_mesh_is_validated_at_construction():
    """As tests/test_serving.py holds the JAX estimator: a spec string is
    resolved, a bucket the data axis does not divide raises, and a mesh
    that needs more ranks than the world has raises with JAX's message."""

    def build(**kw):
        return ZeDOEstimator(params={}, model_cfg=None, sde=None, sampler=None, zcfg=None,
                             clusters=np.zeros((1, 17, 3), np.float32),
                             device=torch.device("cpu"), **kw)

    assert build(mesh="off").mesh is None
    assert build(mesh="auto").mesh is None  # one rank: single-device, as JAX on one device
    assert build(mesh="dp1", batch_bucket=12).mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        build(mesh="dp2")
    with pytest.raises(ValueError, match="divisible"):
        build(batch_bucket=10, mesh=mesh_from_spec("dp3", devices=[0, 1, 2], device="cpu"))
    with pytest.raises(ValueError, match="'data' axis"):
        build(mesh=Mesh(np.arange(1), ("model",), device="cpu"))
