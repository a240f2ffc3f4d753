"""zedo_tpu_torch's full sampling surface (PCSampler.sample_loop, the task
masks, the RK45 ODE sampler, guidance, run.sample) against the JAX package
and the reference's committed goldens.

Deterministic sampling (the probability flow from a given start) is held to
f32 rounding: 1e-5 of the largest value over 50 steps. Noisy sampling is
held, with both packages' normal draws replaced by one fixed array (JAX's
scan draws at trace time, so every step gets the same one), to the same
bound, and without that, by its moments. The ODE sampler within the
reference-parity test's atol 2e-4, rtol 1e-3 of the golden (scipy's RK45)
and 1e-4 of JAX's integrator; the task masks exactly."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

from zedo_tpu.diffusion import guidance as jguidance
from zedo_tpu.diffusion import ode as jode
from zedo_tpu.diffusion import sampling as jsampling
from zedo_tpu.diffusion import score as jscore
from zedo_tpu.diffusion import sde as jsde
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu_torch import presets
from zedo_tpu_torch.diffusion import guidance as tguidance
from zedo_tpu_torch.diffusion import ode as tode
from zedo_tpu_torch.diffusion import sampling as tsampling
from zedo_tpu_torch.diffusion import score as tscore
from zedo_tpu_torch.diffusion import sde as tsde
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.run import sample as tsample
from zedo_tpu_torch.utils import checkpoint as tckpt

N_STEPS = 50
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_CKPT = os.path.join(REPO, "tests", "fixtures", "trained", "checkpoint")


def golden(name):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False) as z:
        files = {k: z[k] for k in z.files}
    return {key: _unflatten(files, key)
            for key in {f.split("/")[0].split("#")[0] for f in files}}


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def score_fns(n=N_STEPS, t_max=0.1):
    """The ODE golden's model (hidden 128) as both packages' score functions
    under the ZeDO sub-VP SDE."""
    sd = golden("test_ode_sampler_parity")["pair_sd"]
    cfg = tsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64)
    jcfg = jsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64)
    params = tckpt.params_from_torch_state_dict(sd, cfg, device="cpu")
    jparams = jckpt.params_from_torch_state_dict(sd, jcfg)
    ts = tsde.SubVPSDE(beta_min=0.1, beta_max=20.0, n=n, t_max=t_max)
    js = jsde.SubVPSDE(beta_min=0.1, beta_max=20.0, n=n, t_max=t_max)
    score = tscore.get_score_fn(ts, lambda x, l, c, m: tsm.apply(params, cfg, x, l, c, m), True)
    jscore_fn = jscore.get_score_fn(js, lambda x, l, c, m: jsm.apply(jparams, jcfg, x, l, c, m),
                                    True)
    return ts, js, score, jscore_fn


def samplers(ts, js, **kw):
    return tsampling.PCSampler(sde=ts, **kw), jsampling.PCSampler(sde=js, **kw)


def share_noise(monkeypatch, z):
    monkeypatch.setattr(tsampling, "_randn", lambda gen, shape, like: torch.from_numpy(z))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z, dtype))


def test_deterministic_sample_loop_matches_jax():
    """The probability flow from a given start, with its trajectory (the
    last entry is the denoised x_mean)."""
    ts, js, score, jscore_fn = score_fns()
    tsamp, jsamp = samplers(ts, js, probability_flow=True, denoise=True, eps=1e-3)
    x0 = np.random.RandomState(0).randn(6, 17, 3).astype(np.float32)
    with torch.no_grad():
        trajs, got = tsamp.sample_loop(score, torch.Generator(), x0.shape,
                                       x_init=torch.from_numpy(x0), return_trajectory=True)
    jtrajs, want = jsamp.sample_loop(jscore_fn, jax.random.PRNGKey(0), x0.shape,
                                     x_init=jnp.asarray(x0), return_trajectory=True)
    close(got.numpy(), want)
    close(trajs.numpy(), jtrajs)
    assert trajs.shape == (N_STEPS, 6, 17, 3) and torch.equal(trajs[-1], got)


def test_noisy_sample_loop_with_imputation_warm_start_and_guidance(monkeypatch):
    """Euler-Maruyama with its noise, comp3d imputation of joints 14-16 and
    a warm start of 5 steps at sde.T, without and with symmetry guidance,
    both packages' normal draws replaced by one array: the same samples.
    Unguided, the known entries (mask 1) end exactly at the condition's
    marginal mean at eps."""
    ts, js, score, jscore_fn = score_fns()
    rs = np.random.RandomState(1)
    x0 = rs.randn(6, 17, 3).astype(np.float32)
    cond = rs.randn(6, 17, 3).astype(np.float32) * 0.3
    share_noise(monkeypatch, rs.randn(6, 17, 3).astype(np.float32))
    mask = tsampling.make_task_mask("comp3d", x0.shape, jlist="14,15,16")
    tsamp, jsamp = samplers(ts, js, probability_flow=False, denoise=True, eps=1e-3)
    for guide in (None, 0.5):
        tg = tguidance.get_sym_gradient_fn(guide) if guide else None
        jg = jguidance.get_sym_gradient_fn(guide) if guide else None
        with torch.no_grad():
            got = tsamp.sample_loop(score, torch.Generator(), x0.shape,
                                    x_init=torch.from_numpy(x0), condition=torch.from_numpy(cond),
                                    mask=torch.from_numpy(mask), warm_start_steps=5,
                                    guidance_fn=tg)
        want = jsamp.sample_loop(jscore_fn, jax.random.PRNGKey(0), x0.shape,
                                 x_init=jnp.asarray(x0), condition=jnp.asarray(cond),
                                 mask=jnp.asarray(mask), warm_start_steps=5, guidance_fn=jg)
        close(got.numpy(), want)
        assert not np.allclose(got.numpy()[:, 14:], x0[:, 14:])
        if guide is None:
            mean_eps = ts.marginal_prob(torch.from_numpy(cond), torch.full((6,), 1e-3))[0]
            known = mask == 1
            np.testing.assert_allclose(got.numpy()[known], mean_eps.numpy()[known], rtol=1e-6)
    # a scalar objective (the reference's loss-returning factory) is refused
    with pytest.raises(ValueError, match="per-coordinate gradient"):
        tsamp.sample_loop(score, torch.Generator(), x0.shape, x_init=torch.from_numpy(x0),
                          guidance_fn=tguidance.get_sym_grad_fn())


def test_noisy_sample_loop_moments_match_jax():
    """Generation from the prior, each package with its own noise: the
    samples' mean within 5 standard errors and their spread within 3% of
    JAX's (2,000 samples of 10 steps, 102,000 values)."""
    ts, js, score, jscore_fn = score_fns(n=10)
    tsamp, jsamp = samplers(ts, js, probability_flow=False, denoise=True, eps=1e-3)
    shape = (2000, 17, 3)
    with torch.no_grad():
        got = tsamp.sample_loop(score, torch.Generator().manual_seed(0), shape).numpy()
    want = np.asarray(jsamp.sample_loop(jscore_fn, jax.random.PRNGKey(0), shape))
    se = want.std() / np.sqrt(want.size)
    assert abs(got.mean() - want.mean()) < 5 * se * np.sqrt(2)
    assert abs(got.std() / want.std() - 1) < 0.03
    assert np.isfinite(got).all()


@pytest.mark.parametrize("task,jlist,randj", [
    ("est", None, None), ("comp2d", "1,2,3", None), ("comp2d", None, 3),
    ("comp3d", "14,15,16", None), ("comp3d", None, 2), ("den", None, None),
    ("gen", None, None)])
def test_task_masks_equal_jax(task, jlist, randj):
    got = tsampling.make_task_mask(task, (7, 17, 3), jlist=jlist, randj=randj, seed=3)
    want = jsampling.make_task_mask(task, (7, 17, 3), jlist=jlist, randj=randj, seed=3)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(tsampling.LIMB_JOINTS, jsampling.LIMB_JOINTS)


def test_task_mask_unknown_raises():
    with pytest.raises(ValueError, match="unknown task"):
        tsampling.make_task_mask("lift", (2, 17, 3))


def test_ode_sampler_matches_golden_and_jax(rng):
    """The golden's transport (scipy RK45 at 1e-7) from the latent rng seed 0
    draws, and JAX's RK45 at the same tolerances."""
    z = rng.randn(4, 17, 3).astype(np.float32)
    ts, js, score, jscore_fn = score_fns(n=1000)
    kw = dict(shape=z.shape, denoise=False, rtol=1e-7, atol=1e-7, eps=1e-3)
    with torch.no_grad():
        got, nfe = tode.ODESampler(sde=ts, **kw).sample(score, z=torch.from_numpy(z))
    want, jnfe = jode.ODESampler(sde=js, **kw).sample(jscore_fn, jax.random.PRNGKey(0),
                                                      z=jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), golden("test_ode_sampler_parity")["want"],
                               atol=2e-4, rtol=1e-3)
    close(got.numpy(), want, rtol=1e-4)
    assert nfe == int(jnfe) and nfe % 7 == 0
    # the denoising step counts one evaluation
    with torch.no_grad():
        den, nfe_d = tode.ODESampler(sde=ts, **{**kw, "denoise": True, "rtol": 1e-5,
                                                 "atol": 1e-5}).sample(
            score, torch.Generator().manual_seed(0))
    assert nfe_d % 7 == 1 and torch.isfinite(den).all()


def test_get_sampling_fn_dispatches_ode():
    config = presets.optim_config("h36m")
    config.sampling.method = "ode"
    sde = tsde.SubVPSDE()
    sampler = tsampling.get_sampling_fn(config, sde, (3, 17, 3), lambda x: x, 1e-3)
    assert isinstance(sampler, tode.ODESampler)
    assert (sampler.shape, sampler.denoise, sampler.eps) == ((3, 17, 3), True, 1e-3)


def test_guidance_matches_golden_and_jax(rng):
    x = rng.randn(5, 17, 3).astype(np.float32) * 0.4
    cond = rng.rand(5, 17, 2).astype(np.float32)
    want = golden("test_guidance_grad_parity")["ref"]
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    got = tguidance.get_match_grad_fn(weight=0.7)(xt, None, ct).numpy()
    np.testing.assert_allclose(got, want["match"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jguidance.get_match_grad_fn(0.7)(
        jnp.asarray(x), None, jnp.asarray(cond))), atol=1e-6)
    got = tguidance.get_sym_grad_fn(weight=1.3)(xt, None).item()
    np.testing.assert_allclose(got, want["sym"], atol=1e-5, rtol=1e-4)
    with torch.no_grad():  # the gradient is taken inside no_grad sampling loops too
        got = tguidance.get_sym_gradient_fn(1.3)(xt, None).numpy()
    np.testing.assert_allclose(got, np.asarray(jguidance.get_sym_gradient_fn(1.3)(
        jnp.asarray(x), None)), atol=1e-6)
    with pytest.raises(ValueError, match="17-joint"):
        tguidance.symmetry_loss(torch.zeros(2, 12, 3))


def _sample(tmp_path, *flags, num_scales=40):
    argv = ["--config", "h36m", "--device", "cpu", "--ckpt_dir", FIXTURE_CKPT,
            "--ckpt_name", "checkpoint_trained.pth", "--override", "model.hidden_dim=256",
            "--override", "model.embed_dim=128", "--override",
            f"model.num_scales={num_scales}", "--save", str(tmp_path / "out.npy"), *flags]
    out = tsample.main(argv)
    saved = np.load(tmp_path / "out.npy")
    np.testing.assert_array_equal(saved, out["samples"].numpy())
    assert np.isfinite(saved).all()
    return out


def test_sample_cli_tasks_on_the_cpu(tmp_path, capsys, monkeypatch):
    """run.sample on the trained fixture: gen, comp3d (the known joints end
    at the condition's marginal mean), den, est, ode (its tolerances
    loosened to 1e-2 here, to keep the CPU run short; the integrator is held
    at the CLI's 1e-5 and tighter in test_ode_sampler_matches_golden_and_jax),
    and both guides; the refusals of the JAX CLI."""
    out = _sample(tmp_path, "--task", "gen", "--num", "8")
    assert out["samples"].shape == (8, 17, 3) and out["nfe"] is None
    poses = np.random.RandomState(0).randn(6, 17, 3).astype(np.float32) * 0.2
    np.save(tmp_path / "poses.npy", poses)
    out = _sample(tmp_path, "--task", "comp3d", "--input", str(tmp_path / "poses.npy"),
                  "--jlist", "14,15,16")
    known = [j for j in range(17) if j not in (14, 15, 16)]
    np.testing.assert_allclose(out["samples"].numpy()[:, known], poses[:, known], atol=1e-3)
    for task in ("den", "est"):
        out = _sample(tmp_path, "--task", task, "--input", str(tmp_path / "poses.npy"),
                      "--warm_start_steps", "3")
        assert out["samples"].shape == (6, 17, 3)
    monkeypatch.setattr(tsample, "ODESampler",
                        functools.partial(tode.ODESampler, rtol=1e-2, atol=1e-2))
    out = _sample(tmp_path, "--sampler", "ode", "--num", "4", num_scales=1000)
    assert out["nfe"] > 0 and "ODE sampler finished" in capsys.readouterr().out
    np.save(tmp_path / "targets.npy", poses[..., :2])
    _sample(tmp_path, "--num", "6", "--guide", "match", "--guide_input",
            str(tmp_path / "targets.npy"))
    _sample(tmp_path, "--num", "6", "--guide", "sym", "--guide_weight", "0.5")
    for flags, msg in ((["--sampler", "ode", "--task", "den", "--input",
                         str(tmp_path / "poses.npy")], "requires the pc sampler"),
                       (["--sampler", "ode", "--guide", "sym"], "--guide requires"),
                       (["--guide", "match"], "--guide_input"),
                       (["--task", "den"], "--input required")):
        with pytest.raises(SystemExit, match=msg):
            _sample(tmp_path, *flags)


def test_sample_cli_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsample.main(["--config", "h36m", "--ckpt_dir", FIXTURE_CKPT,
                      "--ckpt_name", "checkpoint_trained.pth"])
