"""zedo_tpu_torch diffusion layer (diffusion/sde.py, score.py, sampling.py)
against the JAX package and the reference's committed goldens.

Deterministic updates (drift, discretization, probability flow, x_mean) are
held to f32 rounding: 1e-5 relative to the largest value, 1e-4 where a
difference of nearby values takes digits (sub-VP's std = 1 - exp(.) at small
t, VE's sqrt(sigma^2 - sigma_prev^2)). The two packages' noise generators
differ, so noisy updates are held to their moments (the mean of x - x_mean
within 5 standard errors of 0, its spread within 3% of the step's noise
scale, on 204,000 values a check) and, with JAX's normal draws replaced by
the port's, to the same f32 tolerances."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

from zedo_tpu.diffusion import sampling as jsampling
from zedo_tpu.diffusion import score as jscore
from zedo_tpu.diffusion import sde as jsde
from zedo_tpu_torch import presets
from zedo_tpu_torch.diffusion import sampling as tsampling
from zedo_tpu_torch.diffusion import score as tscore
from zedo_tpu_torch.diffusion import sde as tsde
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.utils.checkpoint import params_from_torch_state_dict

RTOL = 1e-5
B_NOISE = 4000  # rows of the moment checks: 4000 x 17 x 3 values


def golden(name):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False) as z:
        files = {k: z[k] for k in z.files}
    return {key: _unflatten(files, key)
            for key in {f.split("/")[0].split("#")[0] for f in files}}


CANCEL_RTOL = 1e-4  # values computed as a difference of nearby values


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


def share_noise(monkeypatch, seed, shape, count=4):
    """JAX's normal draws replaced by the port's: the draws a generator
    seeded `seed` gives in order, all of `shape` (the port draws in the
    order JAX's steps do; JAX draws where the probability flow zeroes the
    noise and the port does not, so spare draws follow)."""
    gen = torch.Generator().manual_seed(seed)
    draws = iter([torch.randn(shape, generator=gen).numpy() for _ in range(count)])
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape_, dtype=jnp.float32: jnp.asarray(next(draws), dtype))


def sde_pairs(n=1000, t_max=0.1):
    return {
        "VPSDE": (tsde.VPSDE(n=n, t_max=t_max, beta_min=0.1, beta_max=20.0),
                  jsde.VPSDE(beta_min=0.1, beta_max=20.0, n=n, t_max=t_max)),
        "subVPSDE": (tsde.SubVPSDE(n=n, t_max=t_max, beta_min=0.1, beta_max=20.0),
                     jsde.SubVPSDE(beta_min=0.1, beta_max=20.0, n=n, t_max=t_max)),
        "VESDE": (tsde.VESDE(n=n, t_max=t_max, sigma_min=0.01, sigma_max=50.0),
                  jsde.VESDE(sigma_min=0.01, sigma_max=50.0, n=n, t_max=t_max)),
    }


def inputs(b=8, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 17, 3).astype(np.float32)
    t = (rs.rand(b).astype(np.float32) * 0.099 + 0.001)
    return x, t


def test_sdes_match_jax_and_golden():
    """The golden's inputs are those of test_sde_parity (rng seed 0)."""
    x, t = inputs()
    want_ref = golden("test_sde_parity")["sdes"]
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    for name, (ts, js) in sde_pairs().items():
        got = {}
        got["marginal_mean"], got["marginal_std"] = ts.marginal_prob(xt, tt)
        got["drift"], diffusion = ts.sde(xt, tt)
        got["disc_f"], disc_g = ts.discretize(xt, tt)
        got["diffusion"] = diffusion * torch.ones(len(t))
        got["disc_G"] = disc_g * torch.ones(len(t))
        jx, jt = jnp.asarray(x), jnp.asarray(t)
        want = dict(zip(("marginal_mean", "marginal_std"), js.marginal_prob(jx, jt)))
        want["drift"], jdiff = js.sde(jx, jt)
        want["disc_f"], jg = js.discretize(jx, jt)
        want["diffusion"], want["disc_G"] = jdiff * jnp.ones(len(t)), jg * jnp.ones(len(t))
        for key, value in got.items():
            close(value.numpy(), want[key])
            np.testing.assert_allclose(value.numpy(), want_ref[name][key], atol=1e-6,
                                       err_msg=f"{name} {key}")


def test_ddpm_params_and_build_sde_match_jax():
    got, want = tsde.get_ddpm_params(0.1, 20.0, 1000), jsde.get_ddpm_params(0.1, 20.0, 1000)
    assert set(got) == set(want)
    for key in want:
        close(np.asarray(got[key]), np.asarray(want[key]))
    for name in ("vpsde", "subvpsde", "vesde"):
        kw = dict(beta_min=0.2, beta_max=10.0, sigma_min=0.02, sigma_max=40.0, n=300,
                  t_max=0.1)
        assert type(tsde.build_sde(name, **kw)).__name__ == type(jsde.build_sde(name, **kw)).__name__
    with pytest.raises(NotImplementedError, match="unknown"):
        tsde.build_sde("cld")
    # the reverse SDE of the probability flow: no diffusion
    x, t = inputs()
    rev = tsde.SubVPSDE(n=1000, t_max=0.1).reverse(lambda x_, t_, c, m: -x_, True)
    assert torch.count_nonzero(rev.sde(torch.from_numpy(x), torch.from_numpy(t))[1]) == 0


def _model(golden_name):
    cfg = tsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64)
    params = params_from_torch_state_dict(golden(golden_name)["pair_sd"], cfg, device="cpu")
    return cfg, params


def test_score_fn_matches_golden():
    """The reference's get_score_fn through its own network: the inputs of
    test_score_fn_parity (the fixture's rng after the state dict)."""
    cfg, params = _model("test_score_fn_parity")
    rs = np.random.RandomState(0)
    x = rs.randn(6, 17, 3).astype(np.float32)
    t = (rs.rand(6).astype(np.float32) * 0.099 + 0.001)
    sde = tsde.SubVPSDE(n=1000, t_max=0.1)

    def model_fn(x_, labels, c, m):
        return tsm.apply(params, cfg, x_, labels, c, m)

    got = tscore.get_score_fn(sde, model_fn, continuous=True)(torch.from_numpy(x),
                                                               torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), golden("test_score_fn_parity")["want"],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["VPSDE", "subVPSDE", "VESDE"])
@pytest.mark.parametrize("continuous", [True, False])
def test_split_score_fn_matches_jax(name, continuous):
    """Both halves against JAX, with a linear stand-in for the network that
    returns its labels in every channel (so the labels are checked too)."""
    ts, js = sde_pairs()[name]
    x, t = inputs()

    def t_model(x_, labels, c, m):
        return x_ * 0.5 + labels.to(x_.dtype)[:, None, None]

    def j_model(x_, labels, c, m):
        return x_ * 0.5 + labels.astype(x_.dtype)[:, None, None]

    t_eval, t_score = tscore.split_score_fn(ts, t_model, continuous)
    j_eval, j_score = jscore.split_score_fn(js, j_model, continuous)
    out = t_eval(torch.from_numpy(x), torch.from_numpy(t))
    close(out.numpy(), j_eval(jnp.asarray(x), jnp.asarray(t)))
    close(t_score(out, torch.from_numpy(x), torch.from_numpy(t)).numpy(),
          j_score(jnp.asarray(out.numpy()), jnp.asarray(x), jnp.asarray(t)), CANCEL_RTOL)


@pytest.mark.parametrize("predictor", ["euler_maruyama", "reverse_diffusion"])
def test_zedo_pc_step_matches_golden(predictor):
    """The reference's pc_sampler at t = 0.07, deterministic probability
    flow: the inputs of test_zedo_pc_step_matches_reference_pc_sampler."""
    name = f"test_zedo_pc_step_matches_reference_pc_sampler__{predictor}"
    cfg, params = _model(name)
    x0 = np.random.RandomState(0).randn(6, 17, 3).astype(np.float32) * 0.3
    sde = tsde.SubVPSDE(n=1000, t_max=0.1, beta_min=0.1, beta_max=20.0)
    sampler = tsampling.PCSampler(sde=sde, predictor=predictor, corrector="none",
                                  probability_flow=True, denoise=True, eps=0.01)
    score_fn = tscore.get_score_fn(
        sde, lambda x_, labels, c, m: tsm.apply(params, cfg, x_, labels, c, m), continuous=True)
    x, x_mean = sampler.zedo_pc_step(score_fn, torch.Generator().manual_seed(0),
                                     torch.from_numpy(x0), 0.07,
                                     condition=torch.zeros(6, 17, 2))
    np.testing.assert_allclose(x_mean.numpy(), golden(name)["want"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(x, x_mean, rtol=0, atol=0)


def _score_pair(scale=1.5):
    """The same analytic score in both frameworks: -scale * x * (1 + t)."""
    def t_fn(x, t, c=None, m=None):
        return -scale * x * (1 + t)[:, None, None]

    def j_fn(x, t, c=None, m=None):
        return -scale * x * (1 + t)[:, None, None]

    return t_fn, j_fn


def _check_noise(x, x_mean, scale):
    """x - x_mean ~ N(0, scale^2) elementwise; scale [B] or a float."""
    z = (x - x_mean) / torch.as_tensor(scale).reshape(-1, 1, 1)
    n = z.numel()
    assert abs(z.mean().item()) < 5 / n ** 0.5, z.mean().item()
    assert abs(z.std().item() - 1) < 0.03, z.std().item()


PREDICTOR_CASES = [("euler_maruyama", name, pf) for name in ("VPSDE", "subVPSDE", "VESDE")
                   for pf in (True, False)] + \
                  [("reverse_diffusion", name, pf) for name in ("VPSDE", "subVPSDE", "VESDE")
                   for pf in (True, False)] + \
                  [("ancestral_sampling", name, False) for name in ("VPSDE", "VESDE")] + \
                  [("none", "subVPSDE", True)]


@pytest.mark.parametrize("predictor,sde_name,pf", PREDICTOR_CASES)
def test_predictors_match_jax(predictor, sde_name, pf, monkeypatch):
    ts, js = sde_pairs()[sde_name]
    t_score, j_score = _score_pair()
    x, t = inputs(B_NOISE, seed=1)
    rtol = CANCEL_RTOL if sde_name == "VESDE" else RTOL
    t_fn, j_fn = tsampling.get_predictor(predictor), jsampling.get_predictor(predictor)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    got, got_mean = t_fn(ts.reverse(t_score, pf), torch.Generator().manual_seed(0), xt, tt)
    share_noise(monkeypatch, 0, x.shape)
    want, want_mean = j_fn(js.reverse(j_score, pf), jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(t))
    close(got_mean.numpy(), want_mean, rtol)
    close(got.numpy(), want, rtol)
    if pf or predictor == "none":
        torch.testing.assert_close(got, got_mean, rtol=0, atol=0)
        return
    if predictor == "euler_maruyama":
        scale = ts.sde(xt, tt)[1] * (1.0 / ts.n) ** 0.5
    elif predictor == "reverse_diffusion":
        scale = ts.discretize(xt, tt)[1]
    elif sde_name == "VESDE":
        sigma, adj = ts.adjacent_sigmas(tt)
        scale = torch.sqrt(adj ** 2 * (sigma ** 2 - adj ** 2) / sigma ** 2)
    else:
        scale = torch.sqrt(ts.discrete_betas(tt)[ts._timestep(tt)])
    scale = scale * torch.ones(len(t))
    keep = scale > 0  # VE's first step adds no noise
    _check_noise(got[keep], got_mean[keep], scale[keep])


def test_ancestral_sampling_refuses_probability_flow():
    ts, _ = sde_pairs()["VPSDE"]
    x, t = inputs()
    with pytest.raises(ValueError, match="Probability flow"):
        tsampling.get_predictor("ancestral_sampling")(
            ts.reverse(_score_pair()[0], True), torch.Generator(), torch.from_numpy(x),
            torch.from_numpy(t))


@pytest.mark.parametrize("corrector", ["langevin", "ald", "none"])
@pytest.mark.parametrize("sde_name", ["VPSDE", "subVPSDE", "VESDE"])
def test_correctors_match_jax(corrector, sde_name, monkeypatch):
    ts, js = sde_pairs()[sde_name]
    t_score, j_score = _score_pair()
    x, t = inputs(B_NOISE, seed=2)
    snr, n_steps = 0.16, 2
    got, got_mean = tsampling.get_corrector(corrector)(
        ts, t_score, torch.Generator().manual_seed(0), torch.from_numpy(x),
        torch.from_numpy(t), None, None, snr, n_steps)
    share_noise(monkeypatch, 0, x.shape)
    want, want_mean = jsampling.get_corrector(corrector)(
        js, j_score, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), None, None,
        snr, n_steps)
    close(got_mean.numpy(), want_mean)
    close(got.numpy(), want)
    if corrector == "none":
        torch.testing.assert_close(got, torch.from_numpy(x), rtol=0, atol=0)
        return
    # the last inner step: x_mean = x_prev + step * score(x_prev), x = x_mean
    # + sqrt(2 step) * noise, with the second draw of the generator
    gen = torch.Generator().manual_seed(0)
    noise = [torch.randn(x.shape, generator=gen) for _ in range(n_steps)][-1]
    step = ((got - got_mean) / noise).median(dim=2).values.median(dim=1).values ** 2 / 2
    _check_noise(got, got_mean, torch.sqrt(2 * step))


@pytest.mark.parametrize("predictor,corrector", [
    ("euler_maruyama", "none"), ("reverse_diffusion", "none"), ("none", "ald"),
    ("euler_maruyama", "langevin"), ("reverse_diffusion", "ald")])
def test_zedo_pc_step_matches_jax(predictor, corrector, monkeypatch):
    """One step on a ScoreMLP (hidden 128), probability flow, with JAX's
    normal draws replaced by the port's."""
    ts, js = sde_pairs()["subVPSDE"]
    x, _ = inputs(64, seed=3)
    from zedo_tpu.models import score_mlp as jsm
    from zedo_tpu_torch.utils.checkpoint import params_from_numpy

    kw = dict(hidden_dim=128, embed_dim=64)
    jparams = jsm.init_params(jax.random.PRNGKey(4), jsm.ScoreMLPConfig(**kw))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg, jcfg = tsm.ScoreMLPConfig(**kw), jsm.ScoreMLPConfig(**kw)
    skw = dict(predictor=predictor, corrector=corrector, probability_flow=True, denoise=True,
               eps=0.01)
    t_score = tscore.get_score_fn(
        ts, lambda x_, lab, c, m: tsm.apply(tparams, tcfg, x_, lab, c, m), continuous=True)
    j_score = jscore.get_score_fn(
        js, lambda x_, lab, c, m: jsm.apply(jparams, jcfg, x_, lab, c, m), continuous=True)
    got, got_mean = tsampling.PCSampler(sde=ts, **skw).zedo_pc_step(
        t_score, torch.Generator().manual_seed(0), torch.from_numpy(x), 0.05)
    share_noise(monkeypatch, 0, x.shape)
    want, want_mean = jsampling.PCSampler(sde=js, **skw).zedo_pc_step(
        j_score, jax.random.PRNGKey(0), jnp.asarray(x), 0.05)
    close(got_mean.numpy(), want_mean, CANCEL_RTOL)
    close(got.numpy(), want, CANCEL_RTOL)


@pytest.mark.parametrize("predictor", sorted(jsampling._PREDICTORS))
@pytest.mark.parametrize("corrector", sorted(jsampling._CORRECTORS))
def test_get_sampling_fn_takes_every_registered_pair(predictor, corrector):
    assert set(tsampling._PREDICTORS) == set(jsampling._PREDICTORS)
    assert set(tsampling._CORRECTORS) == set(jsampling._CORRECTORS)
    config = presets.optim_config("h36m")
    config.sampling.predictor, config.sampling.corrector = predictor, corrector
    sde = tsde.build_sde("subvpsde")
    s = tsampling.get_sampling_fn(config, sde, (1, 17, 3), None, 0.01)
    assert (s.predictor, s.corrector, s.sde) == (predictor, corrector, sde)


def test_get_sampling_fn_refusals():
    sde = tsde.build_sde("subvpsde")
    for key, value, err, match in (("method", "ode", NotImplementedError, "item 12"),
                                   ("method", "ddim", ValueError, "unknown"),
                                   ("predictor", "heun", ValueError, "predictor 'heun'"),
                                   ("corrector", "nuts", ValueError, "corrector 'nuts'")):
        config = presets.optim_config("h36m")
        config.sampling[key] = value
        with pytest.raises(err, match=match):
            tsampling.get_sampling_fn(config, sde, (1, 17, 3), None, 0.01)
    with pytest.raises(ValueError, match="Already registered"):
        tsampling.register_predictor(lambda *a: a, name="none")


def test_prior_sampling_moments():
    like = torch.zeros(B_NOISE, 17, 3)
    for name, (ts, _) in sde_pairs().items():
        x = ts.prior_sampling(torch.Generator().manual_seed(0), like)
        _check_noise(x, torch.zeros_like(x), 50.0 if name == "VESDE" else 1.0)
