"""zedo_tpu_torch training (diffusion/losses.py, diffusion/ema.py,
models/registry.py, train/trainer.py, the training checkpoints, the models'
train paths) against the JAX package and the reference's committed goldens.

The two packages' random draws differ, so the (t, z) and label draws are
injected on both sides, as tests/test_reference_parity.py does, and dropout
is off where trajectories are compared. Tolerances: the losses within the
reference-parity test's rtol 2e-5; K train steps within its atol 3e-4,
rtol 2e-3 of the golden and atol 1e-4, rtol 1e-3 of JAX's step (f32 sums
in another order, compounded through five Adam steps); the EMA exactly."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

from zedo_tpu.diffusion import ema as jema
from zedo_tpu.diffusion import losses as jlosses
from zedo_tpu.diffusion import sde as jsde
from zedo_tpu.models import control_mlp as jcm
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.models import score_mlp_cond as jcond
from zedo_tpu.train import trainer as jtrainer
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu_torch import presets
from zedo_tpu_torch.data.base import PoseDataset
from zedo_tpu_torch.diffusion import ema as tema
from zedo_tpu_torch.diffusion import losses as tlosses
from zedo_tpu_torch.diffusion import sde as tsde
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models import nn as tnn
from zedo_tpu_torch.models import registry as treg
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models import score_mlp_cond as tcond
from zedo_tpu_torch.parallel.mesh import Mesh
from zedo_tpu_torch.train import trainer as ttrainer
from zedo_tpu_torch.utils import checkpoint as tckpt

EPS = 1e-5
T = 0.1


def golden(name):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False) as z:
        files = {k: z[k] for k in z.files}
    return {key: _unflatten(files, key)
            for key in {f.split("/")[0].split("#")[0] for f in files}}


def pair(sd, **cfg_kw):
    """The golden's state dict as the port's and JAX's params (hidden 128,
    embed 64)."""
    cfg = tsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64, **cfg_kw)
    jcfg = jsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64, **cfg_kw)
    return (cfg, tckpt.params_from_torch_state_dict(sd, cfg, device="cpu"),
            jcfg, jckpt.params_from_torch_state_dict(sd, jcfg))


def draws(rng, b=8):
    """The reference-parity tests' inputs: batch, t and z from rng seed 0."""
    batch = rng.randn(b, 17, 3).astype(np.float32) * 0.3
    t_fix = rng.rand(b).astype(np.float32) * (T - EPS) + EPS
    z_fix = rng.randn(b, 17, 3).astype(np.float32)
    return batch, t_fix, z_fix


def inject(monkeypatch, t_fix, z_fix, labels=None):
    """Both packages' (t, z) (and label) draws replaced by the given arrays."""
    u = (t_fix - EPS) / (T - EPS)
    monkeypatch.setattr(tlosses, "_uniform", lambda gen, n, like: torch.from_numpy(u))
    monkeypatch.setattr(tlosses, "_randn", lambda gen, shape, like: torch.from_numpy(z_fix))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(z_fix, dtype))
    if labels is not None:
        monkeypatch.setattr(tlosses, "_randint",
                            lambda gen, high, n, like: torch.from_numpy(labels))
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi: jnp.asarray(labels))


def t_apply(cfg, module=tsm):
    def apply(p, x, labels, cond, msk, train=False, generator=None):
        return module.apply(p, cfg, x, labels, cond, msk, train=train, generator=generator)

    return apply


def j_apply(cfg, module=jsm):
    def apply(p, x, labels, cond, msk, train=False, rng=None):
        return module.apply(p, cfg, x, labels, cond, msk, train=train, rng=rng)

    return apply


@pytest.mark.parametrize("case", ["subvp-True-True-False", "subvp-True-False-True",
                                  "vp-False-True-False"])
def test_sde_loss_matches_golden_and_jax(rng, monkeypatch, case):
    kind, continuous, reduce_mean, lw = case.split("-")
    continuous, reduce_mean, lw = (v == "True" for v in (continuous, reduce_mean, lw))
    want = golden(f"test_sde_loss_parity__{case}")
    cfg, params, jcfg, jparams = pair(want["pair_sd"])
    batch, t_fix, z_fix = draws(rng)
    inject(monkeypatch, t_fix, z_fix)
    cls = (tsde.SubVPSDE, jsde.SubVPSDE) if kind == "subvp" else (tsde.VPSDE, jsde.VPSDE)
    kw = dict(beta_min=0.1, beta_max=20.0, n=1000, t_max=T)
    got = float(tlosses.get_sde_loss_fn(cls[0](**kw), t_apply(cfg), train=False,
                                        reduce_mean=reduce_mean, continuous=continuous,
                                        likelihood_weighting=lw, eps=EPS)(
        params, None, torch.from_numpy(batch)))
    jgot = float(jlosses.get_sde_loss_fn(cls[1](**kw), j_apply(jcfg), train=False,
                                         reduce_mean=reduce_mean, continuous=continuous,
                                         likelihood_weighting=lw, eps=EPS)(
        jparams, jax.random.PRNGKey(0), jnp.asarray(batch)))
    np.testing.assert_allclose(got, float(np.asarray(want["want"])), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, jgot, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["smld", "ddpm"])
def test_discrete_losses_match_jax(rng, monkeypatch, kind):
    cfg, params, jcfg, jparams = pair(golden("test_sde_loss_parity__vp-False-True-False")
                                      ["pair_sd"])
    batch, _, z_fix = draws(rng)
    labels = rng.randint(0, 1000, size=len(batch)).astype(np.int64)
    inject(monkeypatch, np.full(len(batch), EPS, np.float32), z_fix, labels)
    if kind == "smld":
        ts, js = tsde.VESDE(n=1000), jsde.VESDE(n=1000)
        fns = tlosses.get_smld_loss_fn, jlosses.get_smld_loss_fn
    else:
        ts, js = tsde.VPSDE(n=1000), jsde.VPSDE(n=1000)
        fns = tlosses.get_ddpm_loss_fn, jlosses.get_ddpm_loss_fn
    got = float(fns[0](ts, t_apply(cfg), train=False)(params, None, torch.from_numpy(batch)))
    want = float(fns[1](js, j_apply(jcfg), train=False)(jparams, jax.random.PRNGKey(0),
                                                         jnp.asarray(batch)))
    np.testing.assert_allclose(got, want, rtol=2e-5)
    wrong = tsde.VPSDE() if kind == "smld" else tsde.VESDE()
    with pytest.raises(ValueError, match="only works for"):
        fns[0](wrong, t_apply(cfg), False)


def optim_configs(lr=2e-3, warmup=3, grad_clip=0.5, weight_decay=0):
    kw = dict(optimizer="Adam", lr=lr, beta1=0.9, eps=1e-8, warmup=warmup, grad_clip=grad_clip,
              weight_decay=weight_decay)
    jconf = ml_collections.ConfigDict()
    jconf.optim = ml_collections.ConfigDict(kw)
    return presets.Config(optim=presets.Config(kw)), jconf


def run_steps(monkeypatch, rng, k, cfg, params, jcfg, jparams, *, compute_dtype="fp32",
              model=(tsm, jsm), grad_mask=None, jgrad_mask=None, **optim_kw):
    """K train steps through both packages' train steps with injected draws."""
    batch, t_fix, z_fix = draws(rng)
    inject(monkeypatch, t_fix, z_fix)
    tconf, jconf = optim_configs(**optim_kw)
    sde_kw = dict(beta_min=0.1, beta_max=20.0, n=1000, t_max=T)
    optimizer = tlosses.get_optimizer(tconf)
    step = ttrainer.make_train_step(tsde.SubVPSDE(**sde_kw), model[0].apply, cfg, optimizer,
                                    reduce_mean=True, compute_dtype=compute_dtype,
                                    grad_mask=grad_mask)
    state = tlosses.init_train_state(params, optimizer, 0.9999)
    joptimizer = jlosses.get_optimizer(jconf)
    jstep = jtrainer.make_train_step(jsde.SubVPSDE(**sde_kw), model[1].apply, jcfg, joptimizer,
                                     reduce_mean=True, compute_dtype=compute_dtype,
                                     grad_mask=jgrad_mask)
    jstate = jlosses.init_train_state(jparams, joptimizer, 0.9999)
    losses, jlosses_ = [], []
    for _ in range(k):
        state, loss = step(state, None, torch.from_numpy(batch))
        jstate, jloss = jstep(jstate, jax.random.PRNGKey(0), jnp.asarray(batch), None, None)
        losses.append(float(loss))
        jlosses_.append(float(jloss))
    assert state.step == int(jstate.step) == k
    return state, jstate, np.array(losses), np.array(jlosses_)


def assert_params_close(got, want, label, atol, rtol):
    flat_got = tnn.tree_to_flat(got)
    flat_want = jckpt.tree_to_flat(want)
    assert set(flat_got) == set(flat_want), label
    for name, value in flat_got.items():
        np.testing.assert_allclose(value.detach().numpy(), np.asarray(flat_want[name]),
                                   atol=atol, rtol=rtol, err_msg=f"{label} {name}")


def test_train_trajectory_matches_golden_and_jax(rng, monkeypatch):
    """K = 5 steps (warm-up from lr 0, clipping, Adam, EMA) from the
    golden's weights, dropout off, against the reference's trajectory and
    JAX's train step."""
    ref = golden("test_train_step_trajectory_parity")
    cfg, params, jcfg, jparams = pair(ref["pair_sd"], dropout=0.0)
    state, jstate, losses, jl = run_steps(monkeypatch, rng, 5, cfg, params, jcfg, jparams)
    np.testing.assert_allclose(losses, jl, rtol=2e-5)
    for label, got, sd in (("params", state.params, ref["ref"]["params_sd"]),
                           ("ema", tema.params_of(state.ema), ref["ref"]["ema_sd"])):
        want = {k: v for k, v in jckpt.params_from_torch_state_dict(sd, jcfg).items()
                if k != "sigmas"}
        got = {k: v for k, v in got.items() if k != "sigmas"}
        assert_params_close(got, want, label, atol=3e-4, rtol=2e-3)
    assert_params_close(state.params, jstate.params, "params vs jax", atol=1e-4, rtol=1e-3)
    assert_params_close(tema.params_of(state.ema), jema.params_of(jstate.ema), "ema vs jax",
                        atol=1e-4, rtol=1e-3)
    # the first step ran at lr 0 and moved nothing but the moments
    assert state.opt_state.param_groups[0]["lr"] == pytest.approx(2e-3)


def test_bf16_mixed_precision_step_against_jax(rng, monkeypatch):
    """Both packages' mixed precision from the same f32 weights: the port's
    bf16 loss and gradients against JAX's, run op by op. Under jax.jit XLA
    may keep f32 where the program rounds to bf16 (its default excess
    precision), which moves these gradients by 2% here; op by op, each
    rounding is the program's. The port's bf16 loss equals JAX's within
    rtol 2e-5 (the bf16 loss is 3e-4 off the f32 one), and each bf16
    gradient leaf lies within a quarter of its distance from the port's f32
    gradient (measured: an eighth at worst, pre_dense.bias, whose bf16 sum
    reduces in another order; most leaves bit-equal), so a wrapper that
    casts too much or nothing fails. A bf16 train step keeps the master
    weights, the Adam moments and the EMA in f32."""
    ref = golden("test_train_step_trajectory_parity")
    cfg, params, jcfg, jparams = pair(ref["pair_sd"], dropout=0.0)
    batch, t_fix, z_fix = draws(rng)
    inject(monkeypatch, t_fix, z_fix)
    sde_kw = dict(beta_min=0.1, beta_max=20.0, n=1000, t_max=T)

    def port_grads(apply):
        loss_fn = tlosses.get_sde_loss_fn(tsde.SubVPSDE(**sde_kw), apply, True,
                                          reduce_mean=True)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in tnn.tree_to_flat(params).items()}
        loss = loss_fn(tnn.tree_replace(params, leaves), None, torch.from_numpy(batch))
        assert loss.dtype == torch.float32
        names = [k for k in leaves if not tlosses.is_buffer(k)]
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.item(), {k: g.numpy() for k, g in zip(names, grads)}

    loss32, grads32 = port_grads(t_apply(cfg))
    loss16, grads16 = port_grads(tlosses.mixed_precision_apply(t_apply(cfg)))
    jloss_fn = jlosses.get_sde_loss_fn(jsde.SubVPSDE(**sde_kw),
                                       jlosses.mixed_precision_apply(j_apply(jcfg)), True,
                                       reduce_mean=True)
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, jax.random.PRNGKey(0),
                                                 jnp.asarray(batch))
    np.testing.assert_allclose(loss16, float(jloss), rtol=2e-5)
    assert abs(loss16 - loss32) > 1e-4 * loss32
    jflat = jckpt.tree_to_flat(jgrads)
    for name, g32 in grads32.items():
        g16, want = grads16[name], np.asarray(jflat[name])
        assert g16.dtype == want.dtype == np.float32, name
        assert np.linalg.norm(g16 - want) <= 0.25 * np.linalg.norm(g32 - want), name

    tconf, _ = optim_configs()
    optimizer = tlosses.get_optimizer(tconf)
    state = tlosses.init_train_state(params, optimizer, 0.9999)
    step = ttrainer.make_train_step(tsde.SubVPSDE(**sde_kw), tsm.apply, cfg, optimizer,
                                    reduce_mean=True, compute_dtype="bf16")
    for _ in range(2):
        state, loss = step(state, None, torch.from_numpy(batch))
    assert torch.isfinite(loss)
    for name, p in tnn.tree_to_flat(state.params).items():
        assert p.dtype == torch.float32 or tlosses.is_buffer(name), name
    for moments in state.opt_state.state.values():
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32


def test_frozen_leaves_never_move(rng, monkeypatch):
    """The ControlNet adapter with its trunk frozen (trainable_mask) and
    weight decay on. The trainable leaves' gradients equal JAX's (relative
    norm 1e-3; dense2_copy, which the forward does not read, gets zeros as
    under jax.grad); one step moves them by exactly the chain's update (clip
    over the trainable gradients, coupled L2, Adam) computed by hand from
    them; the frozen leaves stay bit-equal and keep no Adam moments. (The
    parameters themselves are not held against JAX's: Adam's first update is
    g / (|g| + eps), so an entry whose clipped, decayed gradient cancels to
    ~1e-7 flips sign with the last bit of f32 rounding.) The loss equals
    JAX's within rtol 1e-5."""
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, dropout=0.0)
    jcfg = jsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, dropout=0.0)
    params = tcm.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a.numpy()), params)
    mask, jmask = tcm.trainable_mask(params), jcm.trainable_mask(jparams)
    flat_mask = tnn.tree_to_flat(mask)
    names = [n for n, m in flat_mask.items() if m and not tlosses.is_buffer(n)]
    lr, wd, clip = 2e-3, 1e-2, 0.5

    batch, t_fix, z_fix = draws(np.random.RandomState(0))
    inject(monkeypatch, t_fix, z_fix)
    sde_kw = dict(beta_min=0.1, beta_max=20.0, n=1000, t_max=T)
    loss_fn = tlosses.get_sde_loss_fn(tsde.SubVPSDE(**sde_kw), t_apply(cfg, tcm), True,
                                      reduce_mean=True)
    leaves = {k: v.clone().requires_grad_(k in names)
              for k, v in tnn.tree_to_flat(params).items()}
    loss = loss_fn(tnn.tree_replace(params, leaves), None, torch.from_numpy(batch))
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    grads = {k: g if g is not None else torch.zeros_like(leaves[k]) for k, g in zip(names, grads)}
    jloss_fn = jlosses.get_sde_loss_fn(jsde.SubVPSDE(**sde_kw), j_apply(jcfg, jcm), True,
                                       reduce_mean=True)
    jgrads = jckpt.tree_to_flat(jax.jit(jax.grad(jloss_fn))(jparams, jax.random.PRNGKey(0),
                                                            jnp.asarray(batch)))
    for k, g in grads.items():
        want = np.asarray(jgrads[k])
        assert np.linalg.norm(g.numpy() - want) <= 1e-3 * max(np.linalg.norm(want), 1e-6), k

    norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    coef = min(1.0, clip / (norm.item() + 1e-6))
    state, _, losses, jl = run_steps(monkeypatch, rng, 1, cfg, params, jcfg, jparams,
                                     model=(tcm, jcm), grad_mask=mask, jgrad_mask=jmask,
                                     warmup=0, weight_decay=wd, lr=lr, grad_clip=clip)
    held = {id(p): n for n, p in state.leaves()}
    with_moments = {held[id(p)] for p in state.opt_state.state}
    before = tnn.tree_to_flat(params)
    for name, p in tnn.tree_to_flat(state.params).items():
        if name in names:
            u = grads[name] * coef + wd * before[name]
            want = before[name] - lr * u / (u.abs() + 1e-8)
            torch.testing.assert_close(p.detach(), want, atol=1e-7, rtol=0, msg=name)
        else:
            assert torch.equal(p, before[name]), name
    assert with_moments == set(names)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)


def test_ema_matches_golden_and_jax_exactly(rng):
    w0 = rng.randn(8, 8).astype(np.float32)
    b0 = rng.randn(8).astype(np.float32)
    traj = [{"weight": w0 + sum(0.01 * (s + 1) for s in range(k)), "bias": b0 - 0.02 * k}
            for k in range(6)]
    state = tema.init({k: torch.from_numpy(np.float32(v)) for k, v in traj[0].items()}, 0.9999)
    jstate = jema.init({k: jnp.asarray(np.float32(v)) for k, v in traj[0].items()}, 0.9999)
    for snap in traj[1:]:
        state = tema.update(state, {k: torch.from_numpy(np.float32(v)) for k, v in snap.items()})
        jstate = jema.update(jstate, {k: jnp.asarray(np.float32(v)) for k, v in snap.items()})
    want = golden("test_ema_update_parity")["want"]
    got = tema.params_of(state)
    for i, key in enumerate(("weight", "bias")):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(jema.params_of(jstate)[key]))
        np.testing.assert_allclose(got[key].numpy(), want[i], atol=1e-6)
    assert state.num_updates == int(jstate.num_updates) == 5
    # without the warm-up, and a bf16 shadow keeps its dtype
    state = tema.init({"w": torch.ones(3, dtype=torch.bfloat16)}, 0.5, use_num_updates=False)
    state = tema.update(state, {"w": torch.zeros(3)})
    assert state.shadow_params["w"].dtype == torch.bfloat16
    assert state.shadow_params["w"].tolist() == [0.5] * 3
    with pytest.raises(ValueError, match="Decay"):
        tema.init({}, 1.5)


def test_lr_schedule_and_optimizer_config():
    tconf, jconf = optim_configs(lr=1e-3, warmup=4)
    sched, jsched = tlosses.lr_schedule(tconf), jlosses.lr_schedule(jconf)
    for step in range(7):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6)
    assert sched(0) == 0.0
    tconf.optim.optimizer = "SGD"
    with pytest.raises(NotImplementedError, match="SGD"):
        tlosses.get_optimizer(tconf)


def test_dropout_and_train_paths():
    """Inverted dropout from the generator passed in; each model's train
    path differs from its eval path only by its draws."""
    x = torch.ones(1000, 64)
    out = tnn.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((out == 0).float().mean().item() - 0.25) < 0.05
    assert tnn.dropout(x, 0.25, False, None) is x
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, dropout=0.1)
    rs = np.random.RandomState(0)
    batch = torch.from_numpy(rs.randn(6, 17, 3).astype(np.float32))
    labels = torch.full((6,), 40.0)
    cond2d = torch.from_numpy(rs.randn(6, 17, 2).astype(np.float32))
    for module, kw in ((tsm, {}), (tcm, {}), (tcond, {"condition": cond2d})):
        params = module.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
        eval_out = module.apply(params, cfg, batch, labels, **kw)
        train = [module.apply(params, cfg, batch, labels, train=True,
                              generator=torch.Generator().manual_seed(s), **kw) for s in (5, 5, 6)]
        assert torch.equal(train[0], train[1]) and not torch.equal(train[0], train[2])
        assert not torch.equal(train[0], eval_out)
        off = dataclasses.replace(cfg, dropout=0.0)
        assert torch.allclose(module.apply(params, off, batch, labels, train=True,
                                           generator=torch.Generator(), **kw),
                              eval_out, atol=1e-6)


def test_random_mask_condition_against_jax():
    """All three condition masks at probability 1 are deterministic: the
    port's and JAX's agree exactly; at probability 0 nothing is masked."""
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32)
    jcfg = jsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32)
    cond = np.random.RandomState(2).randn(4, 17, 3).astype(np.float32)
    for probs in ((0.0, 1.0, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)):
        got = tcond.random_mask_condition(torch.Generator().manual_seed(0),
                                          torch.from_numpy(cond), cfg,
                                          tcond.CondMaskConfig(*probs))
        want = jcond.random_mask_condition(jax.random.PRNGKey(0), jnp.asarray(cond), jcfg,
                                           jcond.CondMaskConfig(*probs))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    half = tcond.random_mask_condition(torch.Generator().manual_seed(0),
                                       torch.ones(4000, 17, 3), cfg,
                                       tcond.CondMaskConfig(0.5, 0.0, 0.0))
    assert abs((half[:, 0, 0] == 0).float().mean().item() - 0.5) < 0.05


def test_registry_matches_jax():
    config = presets.optim_config("h36m")
    params, apply, cfg = treg.create_model(config, device="cpu", hidden_dim=64)
    assert apply is tsm.apply and cfg.hidden_dim == 1024  # the config's own width wins
    config.model.update(hidden_dim=64, embed_dim=32)
    for name, module in (("ncsnpp", tsm), ("control_mlp", tcm), ("score_mlp_cond", tcond)):
        params, apply, cfg = treg.create_model(config, name=name, device="cpu")
        assert apply is module.apply
        assert cfg.hidden_dim == 64 and params["pre_dense"]["weight"].shape == (64, 51)
    with pytest.raises(ValueError, match="Already registered"):
        treg.register_model(treg.get_model("ncsnpp"), name="ncsnpp")


def test_prior_logp_matches_jax():
    z = np.random.RandomState(4).randn(5, 17, 3).astype(np.float32)
    for ts, js in ((tsde.SubVPSDE(), jsde.SubVPSDE()), (tsde.VPSDE(), jsde.VPSDE()),
                   (tsde.VESDE(), jsde.VESDE())):
        np.testing.assert_allclose(ts.prior_logp(torch.from_numpy(z)).numpy(),
                                   np.asarray(js.prior_logp(jnp.asarray(z))), rtol=1e-6)


def test_checkpoint_reads_in_both_packages(tmp_path):
    """A training checkpoint of the port read by the JAX package's
    load_torch_checkpoint (raw and EMA weights): its score_mlp.apply equals
    the port's on the same input; restore_native gives back every leaf."""
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32)
    jcfg = jsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32)
    params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tconf, _ = optim_configs()
    optimizer = tlosses.get_optimizer(tconf)
    state = tlosses.init_train_state(params, optimizer, 0.9)
    state.ema = tema.update(state.ema, tnn.tree_map(lambda a: a * 0.5, params))
    path = str(tmp_path / "checkpoint_3.pth")
    tckpt.save_native(path, 4, 17, state.params, state.ema, state.opt_state.state_dict(), cfg)
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    ckpt = jckpt.load_torch_checkpoint(path, jcfg)
    assert ckpt["step"] == 17 and ckpt["epoch"] == 4 and ckpt["ema_params"] is not None
    rs = np.random.RandomState(1)
    x = rs.randn(5, 17, 3).astype(np.float32)
    labels = np.float32([3.0, 50.5, 99.9, 500.0, 998.0])
    for jp, tp in ((ckpt["params"], state.params), (ckpt["ema_params"], state.ema.shadow_params)):
        want = np.asarray(jsm.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(labels)))
        got = tsm.apply(tp, cfg, torch.from_numpy(x), torch.from_numpy(labels)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
    back = tckpt.restore_native(path, device="cpu")
    assert (back["epoch"], back["step"]) == (4, 17)
    for a, b in ((back["params"], state.params), (back["ema"]["shadow_params"],
                                                   state.ema.shadow_params)):
        fa, fb = tnn.tree_to_flat(a), tnn.tree_to_flat(b)
        assert set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)
    port = tckpt.load_torch_checkpoint(path, cfg, device="cpu")
    assert port["ema_params"] is not None


class FakeDS:
    def __init__(self, rng, n=64):
        self.db_3d = rng.randn(n, 17, 3).astype(np.float32) * 0.1
        self.db_2d = np.zeros((n, 17, 2), np.float32)


def _loop(config, rng_seed, tmp, n_epochs, eval_freq, restore=None, preempt=0):
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, num_scales=20)
    return ttrainer.train_loop(
        config, FakeDS(np.random.RandomState(rng_seed)), output_dir=str(tmp),
        model_cfg=cfg, device="cpu", restore_dir=restore,
        trainer_cfg=ttrainer.TrainerConfig(n_epochs=n_epochs, eval_freq=eval_freq, seed=0,
                                           preemption_ckpt_freq=preempt))


def _train_config():
    config = presets.optim_config("mini")
    config.training.batch_size = 32
    config.model.num_scales = 20
    config.eval.batch_size = 16
    return config


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    """3 epochs, then a resume from the epoch-2 checkpoint to epoch 5, and a
    mid-epoch resume from a preemption checkpoint, both bit-equal to 5
    uninterrupted epochs (params, EMA, Adam moments)."""
    config = _train_config()
    full, hist_full, _ = _loop(config, 0, tmp_path / "a", 5, 2)
    assert full.step == 10 and len(hist_full) == 5 and np.isfinite(hist_full).all()
    assert os.path.exists(tmp_path / "a" / "results_4.npy")
    _loop(config, 0, tmp_path / "b", 3, 2)
    back = tckpt.restore_native(str(tmp_path / "b" / "checkpoint_2.pth"), device="cpu")
    assert (back["epoch"], back["step"]) == (3, 6)
    resumed, hist, _ = _loop(config, 0, tmp_path / "c", 5, 10,
                             restore=str(tmp_path / "b" / "checkpoint_2.pth"))
    assert len(hist) == 2 and hist == hist_full[3:]
    _loop(config, 0, tmp_path / "d", 2, 10, preempt=3)  # saved at step 3, in epoch 1
    mid, hist_mid, _ = _loop(config, 0, tmp_path / "e", 5, 10,
                             restore=str(tmp_path / "d" / "checkpoint_preempt.pth"))
    assert hist_mid[1:] == hist_full[2:]
    for run in (resumed, mid):
        assert run.step == full.step
        for a, b in ((run.params, full.params), (run.ema.shadow_params, full.ema.shadow_params)):
            fa, fb = tnn.tree_to_flat(a), tnn.tree_to_flat(b)
            assert all(torch.equal(fa[k], fb[k]) for k in fa)
        for p, q in zip(run.opt_state.state.values(), full.opt_state.state.values()):
            assert torch.equal(p["exp_avg_sq"], q["exp_avg_sq"])


def test_trainer_eval_metrics_and_conditional_training(tmp_path):
    """An eval epoch with a held-out set: finite Mahalanobis and micro-solve
    MPJPE (plain model on the fast path, the conditional adapter on the
    generic path with its conditions and the joint flip aug)."""
    config = _train_config()
    rng = np.random.RandomState(5)

    class Held:
        db_3d = rng.randn(40, 17, 3).astype(np.float32) * 0.1

    class Writer:  # TensorBoard's SummaryWriter, as the trainer calls it
        scalars = {}

        def add_scalar(self, tag, value, step):
            self.scalars.setdefault(tag, []).append((step, value))

    tcfg = ttrainer.TrainerConfig(n_epochs=1, eval_freq=1, seed=0, micro_solve_iters=5)
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, num_scales=20)
    _, hist, evals = ttrainer.train_loop(config, FakeDS(rng), Held(), output_dir=str(tmp_path),
                                         model_cfg=cfg, trainer_cfg=tcfg, device="cpu",
                                         writer=Writer())
    assert np.isfinite(hist).all() and np.isfinite(list(evals[0].values())).all()
    assert set(evals[0]) == {"prior_mahalanobis", "zeroshot_mpjpe_mm"}
    scalars = Writer.scalars
    assert scalars["Loss/train"] == [(0, hist[0])]
    assert np.mean([v for _, v in scalars["train_loss"]]) == pytest.approx(hist[0])
    assert [i for i, _ in scalars["train_loss"]] == list(range(len(scalars["train_loss"])))
    for key, value in evals[0].items():
        assert scalars[f"Eval/{key}"] == [(0, value)]
    assert set(scalars) == {"train_loss", "Loss/train", "opt_LR_1", "Eval/prior_mahalanobis",
                            "Eval/zeroshot_mpjpe_mm"}

    class Flippable(PoseDataset):
        def __init__(self):  # a training set held in memory, with the flip aug
            self.subset, self.flip, self.rot = "train", True, False
            self.db_3d, self.db_2d = FakeDS(rng).db_3d, rng.randn(64, 17, 2).astype(np.float32)

    ds = Flippable()
    _, hist, evals = ttrainer.train_loop(
        config, ds, Held(), output_dir=str(tmp_path / "cond"), model_cfg=cfg, trainer_cfg=tcfg,
        device="cpu", model_apply_raw=functools.partial(tcond.apply,
                                                        mask_cfg=tcond.CondMaskConfig(0.1)),
        model_init=tcond.init_params, condition_data=ds.db_2d)
    assert np.isfinite(hist).all() and np.isfinite(evals[0]["zeroshot_mpjpe_mm"])
    with pytest.raises(ValueError, match="align"):
        ttrainer.train_loop(config, ds, output_dir=str(tmp_path), model_cfg=cfg,
                            trainer_cfg=tcfg, device="cpu", condition_data=ds.db_2d[:3])
    with pytest.raises(ValueError, match="needs a 'data' axis"):
        ttrainer.train_loop(config, ds, mesh=Mesh(np.arange(1), ("model",), device="cpu"),
                            device="cpu")
