"""zedo_tpu_torch OIL loop (zeroshot/oil.py): the generic path against JAX's
`_run_oil_generic` for the plain, ControlNet and conditional models with
score_reuse 1 and 2, and the per-step diagnostics (`grad_norms`,
`reproj_px`) against JAX's on both paths, with S = 2 hypotheses folded into
the port's batch and vmapped in JAX's.

f32 throughout (JAX at Precision.HIGHEST), 20 steps at hidden 128: poses
and translations within 1e-4 m and 1e-3 relative (the tolerances of
test_torch_pipeline.py's solve), the diagnostics within 1e-4 relative. The shipped sampler
(euler_maruyama, probability flow, no corrector) is deterministic, so the
port matches JAX there whatever the noise; a noisy sampler is held to its
seed (same seed, same result)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu.diffusion.sampling import PCSampler as JPCSampler
from zedo_tpu.diffusion.sde import SubVPSDE as JSubVPSDE
from zedo_tpu.models import control_mlp as jcm
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.models import score_mlp_cond as jcond
from zedo_tpu.zeroshot import oil as joil
from zedo_tpu_torch.diffusion.sampling import PCSampler as TPCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE as TSubVPSDE
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models import score_mlp_cond as tcond
from zedo_tpu_torch.utils.checkpoint import params_from_numpy
from zedo_tpu_torch.zeroshot import oil as toil
from zedo_tpu_torch.zeroshot.infant import _with_condition

N, S, J, STEPS = 6, 2, 17, 20
POSE_TOL, POSE_RTOL, TRACE_RTOL = 1e-4, 1e-3, 1e-4
MODELS = {"plain": (jsm, tsm), "control": (jcm, tcm), "cond": (jcond, tcond)}


def scene(seed=0):
    """S noisy inits around N poses at 4 m, their 2D keypoints and K."""
    rs = np.random.RandomState(seed)
    k = np.tile(np.array([[1000.0, 0, 500.0], [0, 1000.0, 500.0], [0, 0, 1]], np.float32),
                (N, 1, 1))
    pose = rs.randn(N, J, 3).astype(np.float32) * 0.25
    pose -= pose[:, :1]
    t = np.array([0.3, 0.0, 4.0], np.float32)
    cam = pose + t
    px = (cam[..., :2] / cam[..., 2:] * 1000.0 + 500.0).astype(np.float32)
    x0 = (pose[None] + rs.randn(S, N, J, 3) * 0.05).astype(np.float32)
    t0 = np.broadcast_to(t * 0.95, (S, N, 1, 3)).astype(np.float32)
    return x0, t0, px, k


def models(name):
    """Random weights whose output layer is scaled by 0.05: an untrained
    prior at full scale throws the poses metres away in 20 steps, where f32
    rounding no longer compares."""
    jmod, tmod = MODELS[name]
    kw = dict(hidden_dim=128, embed_dim=64)
    jcfg, tcfg = jsm.ScoreMLPConfig(**kw), tsm.ScoreMLPConfig(**kw)
    jparams = jmod.init_params(jax.random.PRNGKey(1), jcfg)
    jparams["post_dense"] = jax.tree.map(lambda a: a * 0.05, jparams["post_dense"])
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmod, tmod, jcfg, tcfg, jparams, tparams


def run_both(name, oil_kw, condition=None, weight=None, generic=True, sampler_kw=None):
    """(port OILResult on S*N folded rows, JAX OILResult vmapped over S)."""
    jmod, tmod, jcfg, tcfg, jparams, tparams = models(name)
    x0, t0, px, k = scene()
    sampler_kw = sampler_kw or {}
    jsde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=STEPS, t_max=0.1)
    tsde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=STEPS, t_max=0.1)
    jsampler, tsampler = JPCSampler(sde=jsde, eps=0.01, **sampler_kw), \
        TPCSampler(sde=tsde, eps=0.01, **sampler_kw)
    cfg = dict(iterations=STEPS, **oil_kw)

    # a plain model through a wrapper takes the generic path in both packages
    j_apply = (lambda *a, **kw: jmod.apply(*a, **kw)) if generic else None
    t_apply = (lambda *a, **kw: tmod.apply(*a, **kw)) if generic else None
    if condition is not None:
        j_inner = j_apply

        def j_apply(p, c, x, labels, cond_arg=None, mask=None, **kw):
            return j_inner(p, c, x, labels, jnp.asarray(condition) if cond_arg is None
                           else cond_arg, mask, **kw)

        t_apply = _with_condition(t_apply, torch.from_numpy(condition).repeat(S, 1, 1))

    def one(x0_s, t0_s):
        return joil.run_oil(jparams, jcfg, jsde, jsampler, x0_s, t0_s, jnp.asarray(px),
                            jnp.asarray(k), None, joil.OILConfig(**cfg),
                            rng=jax.random.PRNGKey(0), precision=jax.lax.Precision.HIGHEST,
                            model_apply=j_apply,
                            reproj_weight=None if weight is None else jnp.asarray(weight))

    want = jax.vmap(one)(jnp.asarray(x0), jnp.asarray(t0))
    got = toil.run_oil(
        tparams, tcfg, tsde, tsampler, torch.from_numpy(x0.reshape(S * N, J, 3)),
        torch.from_numpy(t0.reshape(S * N, 1, 3)), torch.from_numpy(px).repeat(S, 1, 1),
        torch.from_numpy(k).repeat(S, 1, 1), None, toil.OILConfig(**cfg), model_apply=t_apply,
        reproj_weight=None if weight is None else torch.from_numpy(weight).repeat(S),
        n_groups=S)
    return got, want


def check(got, want, track_reproj):
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose).reshape(S * N, J, 3),
                               atol=POSE_TOL, rtol=POSE_RTOL)
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(want.translation).reshape(S * N, 1, 3),
                               atol=POSE_TOL, rtol=POSE_RTOL)
    assert got.grad_norms.shape == got.reproj_px.shape == (S, STEPS)
    np.testing.assert_allclose(got.grad_norms.numpy(), np.asarray(want.grad_norms),
                               rtol=TRACE_RTOL, atol=1e-7)
    if track_reproj:
        np.testing.assert_allclose(got.reproj_px.numpy(), np.asarray(want.reproj_px),
                                   rtol=TRACE_RTOL)
        assert got.reproj_px.min() > 0
    else:
        assert not got.reproj_px.any()


@pytest.mark.parametrize("name", ["plain", "control", "cond"])
@pytest.mark.parametrize("reuse", [1, 2])
def test_generic_path_matches_jax(name, reuse):
    got, want = run_both(name, dict(score_reuse=reuse, track_reproj=True))
    check(got, want, True)


def test_cond_generic_path_with_a_condition_matches_jax():
    cond = np.random.RandomState(4).randn(N, J, 2).astype(np.float32)
    got, want = run_both("cond", dict(track_reproj=True), condition=cond)
    check(got, want, True)
    plain, _ = run_both("cond", dict(track_reproj=True))
    assert (plain.pose - got.pose).abs().max() > 1e-5  # the condition reached the model


@pytest.mark.parametrize("reuse", [1, 2])
@pytest.mark.parametrize("track_reproj", [True, False])
def test_fast_path_diagnostics_match_jax(reuse, track_reproj):
    got, want = run_both("plain", dict(score_reuse=reuse, track_reproj=track_reproj),
                         generic=False)
    check(got, want, track_reproj)


def test_weighted_reproj_trace_matches_jax():
    weight = np.array([0.5, 0.25, 0.25, 0, 0, 0], np.float32)
    got, want = run_both("control", dict(track_reproj=True), weight=weight)
    check(got, want, True)


def test_fast_and_generic_paths_agree():
    """The same shipped dynamics written two ways: the fast path's affine
    step and the sampler's Euler step."""
    fast, _ = run_both("plain", dict(track_reproj=True), generic=False)
    generic, _ = run_both("plain", dict(track_reproj=True))
    torch.testing.assert_close(fast.pose, generic.pose, atol=POSE_TOL, rtol=POSE_RTOL)
    torch.testing.assert_close(fast.reproj_px, generic.reproj_px, rtol=TRACE_RTOL, atol=0)


def test_noisy_sampler_follows_its_generator():
    _, tmod, _, tcfg, _, tparams = models("control")
    x0, t0, px, k = scene()
    sde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=STEPS, t_max=0.1)
    sampler = TPCSampler(sde=sde, predictor="reverse_diffusion", corrector="langevin",
                         probability_flow=False, eps=0.01)
    args = (tparams, tcfg, sde, sampler, torch.from_numpy(x0.reshape(S * N, J, 3)),
            torch.from_numpy(t0.reshape(S * N, 1, 3)), torch.from_numpy(px).repeat(S, 1, 1),
            torch.from_numpy(k).repeat(S, 1, 1), None, toil.OILConfig(iterations=STEPS))

    def run(seed):
        return toil.run_oil(*args, model_apply=tmod.apply, n_groups=S,
                            generator=torch.Generator().manual_seed(seed)).pose

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and (a - c).abs().max() > 1e-6
    # no generator: seeded 0, as JAX's default key
    torch.testing.assert_close(toil.run_oil(*args, model_apply=tmod.apply, n_groups=S).pose, a,
                               rtol=0, atol=0)


def test_oil_refusals():
    _, _, _, tcfg, _, tparams = models("plain")
    x0, t0, px, k = scene()
    sde = TSubVPSDE(n=STEPS, t_max=0.1)
    args = (tparams, tcfg, sde)
    rest = (torch.from_numpy(x0[0]), torch.from_numpy(t0[0]), torch.from_numpy(px),
            torch.from_numpy(k), None, toil.OILConfig(iterations=2))
    with pytest.raises(TypeError, match="pc sampler"):
        toil.run_oil(*args, object(), *rest)
    with pytest.raises(ValueError, match="does not split into 4 groups"):
        toil.run_oil(*args, TPCSampler(sde=sde), *rest, n_groups=4)
    cfg = dataclasses.replace(toil.OILConfig(), iterations=3)
    assert cfg.n_fixed == 0 and toil.OILConfig(iterations=1000).n_fixed == 200


def test_pipeline_solve_reproj_trace_matches_jax():
    """pipeline.solve's SolveResult.reproj_px: [S, steps] with JAX's values
    (S = 2 hypotheses, 20 IPO / 20 OIL steps), None without the trace."""
    from zedo_tpu.zeroshot import ipo as jipo
    from zedo_tpu.zeroshot import pipeline as jpipe
    from zedo_tpu_torch.zeroshot import ipo as tipo
    from zedo_tpu_torch.zeroshot import pipeline as tpipe

    _, _, jcfg, tcfg, jparams, tparams = models("plain")
    x0, _, px, k = scene()
    clusters = x0[:, 0]
    jsde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=STEPS, t_max=0.1)
    tsde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=STEPS, t_max=0.1)
    kw = dict(iterations=STEPS, track_reproj=True)
    want = jpipe.solve(jparams, jcfg, jsde, JPCSampler(sde=jsde, eps=0.01),
                       jpipe.ZeDOConfig(ipo=jipo.IPOConfig(iterations=20),
                                        oil=joil.OILConfig(**kw)),
                       jnp.asarray(clusters), jnp.asarray(px), None, jnp.asarray(k),
                       precision=jax.lax.Precision.HIGHEST)
    args = (tparams, tcfg, tsde, TPCSampler(sde=tsde, eps=0.01))
    got = tpipe.solve(*args, tpipe.ZeDOConfig(ipo=tipo.IPOConfig(iterations=20),
                                              oil=toil.OILConfig(**kw)),
                      torch.from_numpy(clusters), torch.from_numpy(px), None, torch.from_numpy(k))
    assert got.reproj_px.shape == (S, STEPS)
    np.testing.assert_allclose(got.reproj_px.numpy(), np.asarray(want.reproj_px),
                               rtol=TRACE_RTOL)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_TOL,
                               rtol=POSE_RTOL)
    off = tpipe.solve(*args, tpipe.ZeDOConfig(ipo=tipo.IPOConfig(iterations=2),
                                              oil=toil.OILConfig(iterations=2)),
                      torch.from_numpy(clusters), torch.from_numpy(px), None, torch.from_numpy(k))
    assert off.reproj_px is None
