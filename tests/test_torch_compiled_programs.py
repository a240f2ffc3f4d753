"""The JAX package's remaining compiled programs in the port (utils/compiled.py's
step and while_loop; the train step, sample_loop's scan, the RK45 while loop,
the evaluation's hypothesis errors and alignment, serving's rank-and-pack) on
the CPU: each compiled program bit-equal to its eager oracle (on the CPU the
compiled calls run their bodies eagerly on their static or donated buffers),
within the port's existing tolerances of JAX's program, its per-step tables
equal to JAX's values, its cache keyed as jit's, and the entry points reaching
it. The CUDA graphs are held to the eager programs on the card
(tests/test_torch_gpu.py, chip_smoke.py's phase_compiled_programs)."""
import ast
import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (FakeDS, _train_config, assert_params_close, draws, golden, inject,
                              j_apply, optim_configs, pair, run_steps, t_apply)

from zedo_tpu.data import evaluation as jev
from zedo_tpu.diffusion import ema as jema
from zedo_tpu.diffusion import losses as jlosses
from zedo_tpu.diffusion import ode as jode
from zedo_tpu.diffusion import sampling as jsampling
from zedo_tpu.diffusion import score as jscore
from zedo_tpu.diffusion import sde as jsde
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch import serving
from zedo_tpu_torch.data import evaluation as tev
from zedo_tpu_torch.diffusion import ema as tema
from zedo_tpu_torch.diffusion import guidance as tguidance
from zedo_tpu_torch.diffusion import losses as tlosses
from zedo_tpu_torch.diffusion import ode as tode
from zedo_tpu_torch.diffusion import sampling as tsampling
from zedo_tpu_torch.diffusion import score as tscore
from zedo_tpu_torch.diffusion import sde as tsde
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models import nn as tnn
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops import procrustes as tproc
from zedo_tpu_torch.parallel.mesh import Mesh
from zedo_tpu_torch.train import trainer as ttrainer
from zedo_tpu_torch.utils import checkpoint as tckpt
from zedo_tpu_torch.utils import compiled

CPU = torch.device("cpu")
SDE_KW = dict(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)


# ------------------------------------------------------------------ helpers


def small_train(dtype="fp32", control=False, warmup=3, seed=0, rows=32):
    """(eager step, compiled step, two TrainStates of one seeded init, the
    batch, the grad mask): a small ScoreMLP (or ControlNet with its trunk
    frozen) with dropout on."""
    module = tcm if control else tsm
    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, dropout=0.1)
    tconf, _ = optim_configs(warmup=warmup, weight_decay=1e-2 if control else 0)
    optimizer = tlosses.get_optimizer(tconf)
    apply = t_apply(cfg, module)
    if dtype == "bf16":
        apply = tlosses.mixed_precision_apply(apply)
    params = module.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    mask = tcm.trainable_mask(params) if control else None
    steps = [tlosses.get_step_fn(tsde.SubVPSDE(**SDE_KW), apply, optimizer, train=True,
                                 reduce_mean=True, grad_mask=mask, compiled=c)
             for c in (False, True)]
    states = [tlosses.init_train_state(params, optimizer, 0.999) for _ in range(2)]
    batch = torch.from_numpy(np.random.RandomState(seed).randn(rows, 17, 3).astype(np.float32)
                             * 0.3)
    return steps, states, batch, mask


def same_state(a, b):
    for tree_a, tree_b in ((a.params, b.params), (a.ema.shadow_params, b.ema.shadow_params)):
        fa, fb = tnn.tree_to_flat(tree_a), tnn.tree_to_flat(tree_b)
        assert set(fa) == set(fb)
        for name in fa:
            assert torch.equal(fa[name], fb[name]), name
    assert torch.equal(a.ema.num_updates, b.ema.num_updates) and a.step == b.step
    assert len(a.opt_state.state) == len(b.opt_state.state)
    for (_, pa), (_, pb) in zip(a.leaves(), b.leaves()):
        sa, sb = a.opt_state.state.get(pa, {}), b.opt_state.state.get(pb, {})
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key


def golden_model(n=50, t_max=0.1):
    """The ODE golden's model (hidden 128) as both packages' weights and
    score functions under the ZeDO sub-VP SDE."""
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
    return cfg, params, ts, js, score, jscore_fn


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def hypotheses(seed=5, n=30, s=5):
    rng = np.random.RandomState(seed)
    gt = (rng.randn(n, 17, 3) * 0.3).astype(np.float32)
    gt -= gt[:, 0:1]
    preds = (gt[:, None] + rng.randn(n, s, 17, 3) * 0.05).astype(np.float32)
    return gt, preds


ERROR_CASES = [(p2, subset, first) for p2 in (False, True)
               for subset, first in ((None, True), ((1, 2, 3, 5, 9, 14), True),
                                     ((1, 2, 3, 5, 9, 14), False))]


# ---------------------------------------------- (a) compiled == eager, bitwise


@pytest.mark.parametrize("case", ["fp32", "bf16", "grad_mask"])
def test_compiled_train_steps_equal_eager(case):
    """K = 4 train steps (warm-up from lr 0, clip, Adam, EMA, dropout from
    each step's seeded generator): the compiled step on the state's own
    tensors against the eager step, the losses, params, Adam's moments and
    counts, the EMA and the generators bit-equal; frozen leaves keep no
    moments."""
    steps, states, batch, mask = small_train("bf16" if case == "bf16" else "fp32",
                                             control=case == "grad_mask")
    for i in range(4):
        got = []
        for k in range(2):
            gen = torch.Generator().manual_seed(10 + i)
            states[k], loss = steps[k](states[k], gen, batch)
            got.append((loss, gen.get_state()))
        assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    same_state(*states)
    assert states[1].step == 4 and int(states[1].ema.num_updates) == 4
    if mask is not None:
        flat = tnn.tree_to_flat(mask)
        held = {id(p): n for n, p in states[1].leaves()}
        assert {held[id(p)] for p in states[1].opt_state.state} == {
            n for n, m in flat.items() if m and not tlosses.is_buffer(n)}


def test_compiled_sample_loop_equals_eager():
    """sample_loop with comp3d imputation, a warm start, symmetry guidance,
    a Langevin corrector and the trajectory: the compiled scan of
    sample_loop_jit and sample_loop(score_fn) bit-equal, each leaving the
    generator where the other does."""
    cfg, params, ts, _, score, _ = golden_model(n=20)
    sampler = tsampling.PCSampler(sde=ts, corrector="langevin", probability_flow=False,
                                  eps=1e-3)
    rs = np.random.RandomState(1)
    shape = (6, 17, 3)
    cond = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.3)
    mask = torch.from_numpy(tsampling.make_task_mask("comp3d", shape, jlist="14,15,16"))
    kw = dict(condition=cond, mask=mask, warm_start_steps=4, return_trajectory=True,
              guidance_fn=tguidance.get_sym_gradient_fn(0.5))
    outs = []
    for run in ("eager", "jit"):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            if run == "eager":
                out = sampler.sample_loop(score, gen, shape, **kw)
            else:
                out = sampler.sample_loop_jit(tsm.apply, params, cfg, gen, shape, **kw)
        outs.append((out, gen.get_state()))
    (trajs, x), state = outs[0]
    assert trajs.shape == (20,) + shape and torch.equal(trajs[-1], x)
    for (t2, x2), s2 in outs[1:]:
        assert torch.equal(t2, trajs) and torch.equal(x2, x) and torch.equal(s2, state)


def _decay(t, y):
    return -3.0 * y * (1.0 + t)


def test_compiled_rk45_equals_eager_and_its_chunk_changes_nothing(monkeypatch):
    """rk45 on dy/dt = -3 y (1 + t): its eager while loop and the same loop
    compiled (the one that ODESampler.sample_jit runs) bit-equal with the
    same NFE, for chunks of 1, 8 and 13 steps (a chunk only moves where the
    host reads), the host reads one a chunk; and within the integrator's
    tolerances of the exact solution."""
    y0 = torch.from_numpy(np.random.RandomState(0).rand(5, 3).astype(np.float32))
    f = functools.partial(tode._call_f, f=_decay)
    runs = []
    for chunk in (1, 8, 13):
        monkeypatch.setattr(tode, "CHUNK", chunk)
        for flag in (False, True):
            before = compiled.host_reads()
            if flag:
                y, nfe = tode._rk45(f, {}, 0.0, 1.0, y0, 1e-5, 1e-5, 20000, compiled=True)
            else:
                y, nfe = tode.rk45(_decay, 0.0, 1.0, y0)
            runs.append((y, int(nfe), compiled.host_reads() - before, chunk))
    y, nfe = runs[0][:2]
    for got, got_nfe, reads, chunk in runs:
        assert torch.equal(got, y) and got_nfe == nfe
        assert reads == -(-(nfe // 7) // chunk)
    # within the integrator's own tolerances (atol = rtol = 1e-5 a step)
    exact = y0.numpy() * np.exp(-3.0 * 1.5)
    np.testing.assert_allclose(y.numpy(), exact, rtol=1e-3, atol=1e-5)


def test_compiled_ode_sampler_equals_eager():
    """ODESampler.sample_jit against sample(score_fn): bit-equal samples and
    NFE, the denoising step included."""
    cfg, params, ts, _, score, _ = golden_model(n=1000)
    z = torch.from_numpy(np.random.RandomState(2).randn(4, 17, 3).astype(np.float32))
    sampler = tode.ODESampler(sde=ts, shape=z.shape, denoise=True)
    with torch.no_grad():
        want, nfe = sampler.sample(score, z=z)
        got, got_nfe = sampler.sample_jit(tsm.apply, params, cfg, z=z)
        assert torch.equal(got, want) and got_nfe == nfe
    assert nfe % 7 == 1


@pytest.mark.parametrize("protocol2,subset,first", ERROR_CASES)
def test_compiled_hypothesis_errors_equal_eager(protocol2, subset, first):
    """_hypothesis_errors_jit (protocol 2: the two calls around the SVD)
    against the eager oracle and against one eager procrustes-based pass:
    bit-equal."""
    gt, preds = hypotheses()
    p, g = torch.from_numpy(preds), torch.from_numpy(gt)
    want = tev._hypothesis_errors(p, g, protocol2, subset, first)
    assert torch.equal(tev._hypothesis_errors_jit(p, g, protocol2, subset, first), want)
    if protocol2 and subset is None:  # procrustes in one function: the same bits
        aligned = tproc.procrustes(g[:, None].expand(p.shape).reshape(-1, 17, 3),
                                   p.reshape(-1, 17, 3)).z.reshape(p.shape)
        assert torch.equal(want, tev.mpjpe(aligned, g[:, None].expand(p.shape)))


def test_compiled_alignment_and_packing_equal_eager():
    """align_to_gt_batched bit-equal to procrustes of the folded batch;
    serving's _rank_and_pack_jit equal to _rank_and_pack."""
    gt, preds = hypotheses(seed=8)
    p, g = torch.from_numpy(preds), torch.from_numpy(gt)[:, None]
    want = tproc.procrustes(g.expand(p.shape).reshape(-1, 17, 3), p.reshape(-1, 17, 3)).z
    assert torch.equal(tproc.align_to_gt_batched(p, g), want.reshape(p.shape))
    rs = np.random.RandomState(4)
    k = torch.tensor([[1000.0, 0, 500], [0, 1000.0, 500], [0, 0, 1]]).expand(30, 3, 3)
    trans = torch.from_numpy(rs.rand(30, 5, 1, 3).astype(np.float32)) + torch.tensor([0, 0, 4.0])
    kp = torch.from_numpy(rs.rand(30, 17, 3).astype(np.float32) * 1000)
    want = serving._rank_and_pack(p, trans, kp, k)
    assert torch.equal(serving._rank_and_pack_jit(p, trans, kp, k), want)
    assert want.shape == (30, 5 * 17 * 3 + 5 * 3 + 5)


# ------------------------------------------------------- (b) against JAX


def test_compiled_train_trajectory_matches_jax(rng, monkeypatch, recorded):
    """make_train_step's compiled step, K = 5 steps from the golden's weights
    against JAX's jitted step: the losses within rtol 2e-5, the params and
    the EMA within atol 1e-4, rtol 1e-3 (test_torch_train.py's bounds)."""
    cfg, params, jcfg, jparams = pair(golden("test_train_step_trajectory_parity")["pair_sd"],
                                      dropout=0.0)
    state, jstate, losses, jl = run_steps(monkeypatch, rng, 5, cfg, params, jcfg, jparams)
    np.testing.assert_allclose(losses, jl, rtol=2e-5)
    assert_params_close(state.params, jstate.params, "params vs jax", atol=1e-4, rtol=1e-3)
    assert_params_close(tema.params_of(state.ema), jema.params_of(jstate.ema), "ema vs jax",
                        atol=1e-4, rtol=1e-3)
    assert ("_train_body", True) in recorded


def test_compiled_bf16_step_matches_jax_loss_and_eager(rng, monkeypatch):
    """The compiled bf16 mixed-precision step: its first loss equals JAX's
    bf16 loss within rtol 2e-5 (test_torch_train.py's bound), two steps are
    bit-equal to the eager step's, and the master weights, moments and EMA
    stay f32."""
    cfg, params, jcfg, jparams = pair(golden("test_train_step_trajectory_parity")["pair_sd"],
                                      dropout=0.0)
    batch, t_fix, z_fix = draws(rng)
    inject(monkeypatch, t_fix, z_fix)
    tconf, _ = optim_configs()
    optimizer = tlosses.get_optimizer(tconf)
    apply = tlosses.mixed_precision_apply(t_apply(cfg))
    steps = [tlosses.get_step_fn(tsde.SubVPSDE(**SDE_KW), apply, optimizer, train=True,
                                 reduce_mean=True, compiled=c) for c in (False, True)]
    states = [tlosses.init_train_state(params, optimizer, 0.9999) for _ in range(2)]
    losses = [[], []]
    for _ in range(2):
        for k in range(2):
            states[k], loss = steps[k](states[k], None, torch.from_numpy(batch))
            losses[k].append(loss)
    assert all(torch.equal(a, b) for a, b in zip(*losses))
    same_state(*states)
    jloss_fn = jlosses.get_sde_loss_fn(jsde.SubVPSDE(**SDE_KW),
                                       jlosses.mixed_precision_apply(j_apply(jcfg)), True,
                                       reduce_mean=True)
    jloss = jloss_fn(jparams, jax.random.PRNGKey(0), jnp.asarray(batch))
    np.testing.assert_allclose(float(losses[1][0]), float(jloss), rtol=2e-5)
    for moments in states[1].opt_state.state.values():
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32


@pytest.mark.parametrize("decay,warm", [(0.9999, True), (0.5, True), (0.999, False)])
def test_in_place_ema_matches_jax_exactly(rng, decay, warm):
    """The train step's in-place EMA update (device count, f32 decay on the
    device) against JAX's update: bit-equal over 6 updates, the count too."""
    traj = [{"weight": (rng.randn(8, 8) * (1 + k)).astype(np.float32),
             "bias": rng.randn(8).astype(np.float32)} for k in range(7)]
    state = tema.init({k: torch.from_numpy(v) for k, v in traj[0].items()}, decay,
                      use_num_updates=warm)
    jstate = jema.init({k: jnp.asarray(v) for k, v in traj[0].items()}, decay,
                       use_num_updates=warm)
    shadow = state.shadow_params
    for snap in traj[1:]:
        tema.update_(state, {k: torch.from_numpy(v) for k, v in snap.items()})
        jstate = jema.update(jstate, {k: jnp.asarray(v) for k, v in snap.items()})
    assert state.shadow_params is shadow
    for key in ("weight", "bias"):
        np.testing.assert_array_equal(shadow[key].numpy(), np.asarray(jstate.shadow_params[key]))
    assert int(state.num_updates) == int(jstate.num_updates) == (6 if warm else -1)


def test_deterministic_sample_loop_jit_matches_jax():
    """The compiled probability flow from a given start with its trajectory
    against JAX's lax.scan, at test_torch_sample.py's 1e-5."""
    cfg, params, ts, js, _, jscore_fn = golden_model()
    kw = dict(probability_flow=True, denoise=True, eps=1e-3)
    tsamp, jsamp = tsampling.PCSampler(sde=ts, **kw), jsampling.PCSampler(sde=js, **kw)
    x0 = np.random.RandomState(0).randn(6, 17, 3).astype(np.float32)
    with torch.no_grad():
        trajs, got = tsamp.sample_loop_jit(tsm.apply, params, cfg, torch.Generator(), x0.shape,
                                           x_init=torch.from_numpy(x0), return_trajectory=True)
    jtrajs, want = jsamp.sample_loop(jscore_fn, jax.random.PRNGKey(0), x0.shape,
                                     x_init=jnp.asarray(x0), return_trajectory=True)
    close(got.numpy(), want)
    close(trajs.numpy(), jtrajs)


def test_compiled_ode_matches_jax_nfe_and_samples(rng):
    """The compiled RK45 against JAX's lax.while_loop at test_torch_sample.py's
    tolerances: the samples within 1e-4 and the NFE equal."""
    z = rng.randn(4, 17, 3).astype(np.float32)
    cfg, params, ts, js, _, jscore_fn = golden_model(n=1000)
    kw = dict(shape=z.shape, denoise=False, rtol=1e-7, atol=1e-7, eps=1e-3)
    with torch.no_grad():
        got, nfe = tode.ODESampler(sde=ts, **kw).sample_jit(tsm.apply, params, cfg,
                                                            z=torch.from_numpy(z))
    want, jnfe = jode.ODESampler(sde=js, **kw).sample(jscore_fn, jax.random.PRNGKey(0),
                                                      z=jnp.asarray(z))
    close(got.numpy(), want, rtol=1e-4)
    assert nfe == int(jnfe) and nfe % 7 == 0


@pytest.mark.parametrize("protocol2,subset,first", ERROR_CASES)
def test_compiled_hypothesis_errors_match_jax(protocol2, subset, first):
    """_hypothesis_errors_jit against JAX's at test_torch_eval.py's rtol 1e-5,
    atol 1e-7 of the largest error."""
    gt, preds = hypotheses(seed=9)
    got = tev._hypothesis_errors_jit(torch.from_numpy(preds), torch.from_numpy(gt), protocol2,
                                     subset, first)
    want = np.asarray(jev._hypothesis_errors_jit(jnp.asarray(preds), jnp.asarray(gt), protocol2,
                                                 subset, first))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-7 + 1e-5 * np.abs(want).max())


# ------------------------------------------------ (c) the bodies' tables


@pytest.mark.parametrize("warmup", [0, 3, 5000])
def test_lr_table_equals_jax_schedule(warmup):
    """The train body's learning-rate table: JAX's schedule (f32 on the
    device) at steps 0..warmup exactly, and every later step reads the last
    entry, as the schedule stays flat."""
    tconf, jconf = optim_configs(lr=2e-4, warmup=warmup)
    table = tlosses.get_optimizer(tconf).table()
    assert table.dtype == np.float32 and table.shape == (max(warmup, 0) + 1,)
    steps = np.arange(warmup + 3)
    # a flat schedule is a Python number (optax takes it as f32)
    want = np.broadcast_to(np.asarray(jlosses.lr_schedule(jconf)(jnp.asarray(steps, jnp.int32)),
                                      np.float32), steps.shape)
    got = table[np.minimum(steps, len(table) - 1)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decay,warm", [(0.999, True), (0.9999, True), (0.999, False)])
def test_ema_decays_equal_jax(decay, warm):
    """The decay of each EMA update, computed on the device from the count,
    equals JAX's jnp.minimum(decay, (1 + n) / (10 + n)) in f32 bit for bit."""
    state = tema.init({"w": torch.zeros(2)}, decay, use_num_updates=warm)
    counts = np.arange(0, 12000, 37, dtype=np.int32) if warm else np.array([-1], np.int32)
    for count in counts:
        state.num_updates = torch.tensor(int(count), dtype=torch.int32)
        n, one_minus = tema._next(state)
        jn = jnp.where(count >= 0, jnp.int32(count) + 1, jnp.int32(count))
        jdecay = jnp.where(jn >= 0, jnp.minimum(jnp.float32(decay), (1.0 + jn) / (10.0 + jn)),
                           jnp.float32(decay))
        assert int(n) == int(jn)
        assert np.float32(one_minus.item()) == np.float32(1.0 - jdecay), count


@pytest.mark.parametrize("warm", [0, 5, 20])
def test_sample_loop_time_table_equals_jax(monkeypatch, warm):
    """sample_loop's table of step times against the xs of JAX's scan
    (recorded by monkeypatching jax.lax.scan) with its warm-start pinning:
    sde.T for the first `warm` steps, then the linspace."""
    cfg, params, ts, js, score, jscore_fn = golden_model(n=20)
    seen = {}
    real = jax.lax.scan

    def record(body, init, xs, *args, **kw):
        seen["xs"] = xs
        return real(body, init, xs, *args, **kw)

    monkeypatch.setattr(jax.lax, "scan", record)
    jsamp = jsampling.PCSampler(sde=js, eps=1e-3)
    jsamp.sample_loop(jscore_fn, jax.random.PRNGKey(0), (2, 17, 3), warm_start_steps=warm)
    t, i = (np.asarray(a) for a in seen["xs"])
    want = np.where(i < warm, np.float32(js.T), t)
    got = tsampling.PCSampler(sde=ts, eps=1e-3).time_table(warm, torch.zeros(1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:warm], np.float32(ts.T))


# ---------------------------------------------------------- (d) the cache


def test_sample_loop_cache_takes_new_weights():
    """Two compiled sample loops of the same shapes and statics make one
    entry; new weights of the same shapes make none and give the eager
    loop's new result."""
    cfg, params, ts, _, _, _ = golden_model(n=10)
    sampler = tsampling.PCSampler(sde=ts, probability_flow=False, eps=1e-3)
    compiled.clear_cache()
    new = tnn.tree_map(lambda a: a * 0.9, params)
    outs = {}
    for name, p in (("a", params), ("a2", params), ("b", new)):
        with torch.no_grad():
            outs[name] = sampler.sample_loop_jit(tsm.apply, p, cfg,
                                                 torch.Generator().manual_seed(0), (4, 17, 3))
    assert compiled.cache_info() == {"hits": 2, "misses": 1, "entries": 1,
                                     "captures": 0, "capture_s": 0.0}
    assert torch.equal(outs["a"], outs["a2"]) and not torch.equal(outs["a"], outs["b"])
    score = tscore.get_score_fn(ts, lambda x, l, c, m: tsm.apply(new, cfg, x, l, c, m), True)
    with torch.no_grad():
        want = sampler.sample_loop(score, torch.Generator().manual_seed(0), (4, 17, 3))
    assert torch.equal(outs["b"], want)


def test_train_step_cache_is_one_entry_a_state():
    """The donated train step: one entry for the K steps of one state, a new
    one for another state's tensors (the graph is bound to them)."""
    compiled.clear_cache()
    steps, states, batch, _ = small_train()
    for _ in range(3):
        steps[1](states[1], torch.Generator().manual_seed(0), batch)
    assert compiled.cache_info() == {"hits": 2, "misses": 1, "entries": 1,
                                     "captures": 0, "capture_s": 0.0}
    steps[1](states[0], torch.Generator().manual_seed(0), batch)
    assert compiled.cache_info()["entries"] == 2


def test_a_dropped_state_releases_its_entry():
    """The donated train step's entry lives as long as its state: once the
    state is gone the entry leaves the cache; a live state's stays."""
    import gc

    compiled.clear_cache()
    steps, states, batch, _ = small_train()
    for state in states:
        steps[1](state, torch.Generator().manual_seed(0), batch)
    assert compiled.cache_info()["entries"] == 2
    kept = states[1]
    del states, state
    gc.collect()
    assert compiled.cache_info()["entries"] == 1
    steps[1](kept, torch.Generator().manual_seed(0), batch)
    assert compiled.cache_info() == {"hits": 1, "misses": 2, "entries": 1,
                                     "captures": 0, "capture_s": 0.0}


def test_a_second_eval_epoch_adds_no_entry(tmp_path, monkeypatch):
    """train_loop with an eval epoch after each of 2 epochs: one compiled
    train step, one compiled eval sampler (the second epoch's new EMA
    weights replay it) and the micro solve's IPO and OIL scans; the train
    step's entry leaves the cache with the loop's state."""
    compiled.clear_cache()
    made = []
    real = compiled._entry

    def spy(key, make, donated=None):
        if key not in compiled._CACHE:
            made.append(key[0].__name__)
        return real(key, make, donated)

    monkeypatch.setattr(compiled, "_entry", spy)
    config = _train_config()
    rng = np.random.RandomState(5)

    class Held:
        db_3d = rng.randn(40, 17, 3).astype(np.float32) * 0.1

    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1, num_scales=20)
    tcfg = ttrainer.TrainerConfig(n_epochs=2, eval_freq=1, seed=0, micro_solve_iters=5)
    ttrainer.train_loop(config, FakeDS(rng), Held(), output_dir=str(tmp_path), model_cfg=cfg,
                        trainer_cfg=tcfg, device="cpu")
    assert sorted(made) == sorted(["_train_body", "_pc_body", "_ipo_body", "_fast_body"]), made
    assert compiled.cache_info()["misses"] == 4
    funcs = [key[0].__name__ for key in compiled._CACHE]
    assert sorted(funcs) == sorted(["_pc_body", "_ipo_body", "_fast_body"]), funcs


def test_ode_cache_is_one_entry():
    cfg, params, ts, _, _, _ = golden_model(n=1000)
    sampler = tode.ODESampler(sde=ts, shape=(3, 17, 3), rtol=1e-3, atol=1e-3)
    compiled.clear_cache()
    with torch.no_grad():
        for seed in (0, 1):
            sampler.sample_jit(tsm.apply, params, cfg, torch.Generator().manual_seed(seed))
    assert compiled.cache_info() == {"hits": 1, "misses": 1, "entries": 1,
                                     "captures": 0, "capture_s": 0.0}


# ------------------------------------------- (e) the entry points reach them


class _Stop(Exception):
    pass


@pytest.fixture
def recorded(monkeypatch):
    """(body function's name, compiled) of every call of compiled.scan, step
    and while_loop."""
    calls = []
    for name in ("scan", "step", "while_loop"):
        real = getattr(compiled, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            body = args[1] if _name == "while_loop" else args[0]
            calls.append((body.func.__name__, kw.get("compiled", False)))
            return _real(*args, **kw)

        monkeypatch.setattr(compiled, name, wrapper)
    return calls


def _sample_cli(tmp_path, *flags):
    from zedo_tpu_torch.run import sample

    fixture = f"{tbt.FIXTURE}/checkpoint"
    return sample.main(["--config", "h36m", "--device", "cpu", "--ckpt_dir", fixture,
                        "--ckpt_name", "checkpoint_trained.pth", "--override",
                        "model.hidden_dim=256", "--override", "model.embed_dim=128",
                        "--save", str(tmp_path / "out.npy"), *flags])


ENTRY_POINTS = ["train_loop", "sharded_step", "tp_sharded_step", "bench_train",
                "make_trained_fixture", "run_sample_pc", "run_sample_ode",
                "trainer_eval_sampling", "multi_hypothesis_eval", "predict"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_reach_the_compiled_programs(entry, recorded, monkeypatch, tmp_path):
    """Each entry point whose JAX counterpart runs a jitted program calls the
    compiled one (compiled=True), as test_torch_solve_jit.py checks for the
    solve; the tensor-parallel step keeps its gradients eager (its forward
    runs collectives) and compiles its update."""
    want = {"_train_body"}
    if entry == "train_loop":
        ttrainer.train_loop(_train_config(), FakeDS(np.random.RandomState(0), n=64),
                            output_dir=str(tmp_path), device="cpu",
                            model_cfg=tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32,
                                                         n_blocks=1, num_scales=20),
                            trainer_cfg=ttrainer.TrainerConfig(n_epochs=1, eval_freq=10))
    elif entry in ("sharded_step", "tp_sharded_step"):
        cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32, n_blocks=1)
        optimizer = tlosses.get_optimizer(optim_configs()[0])
        params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        if entry == "sharded_step":
            mesh, rules = Mesh(np.arange(1), ("data",), device="cpu"), None
        else:
            from zedo_tpu_torch.parallel import tensor_parallel as tp_lib

            mesh = Mesh(np.arange(1).reshape(1, 1), ("data", "model"), device="cpu")
            rules = tp_lib.check(params, cfg, mesh)
        step, rows = ttrainer.make_sharded_train_step(mesh, tsde.SubVPSDE(**SDE_KW), tsm.apply,
                                                      cfg, optimizer, tp_rules=rules)
        state = tlosses.init_train_state(params, optimizer, 0.999)
        one = ttrainer.make_train_step(tsde.SubVPSDE(**SDE_KW), tsm.apply, cfg, optimizer)
        single = tlosses.init_train_state(params, optimizer, 0.999)
        batch = torch.from_numpy(np.random.RandomState(0).randn(8, 17, 3).astype(np.float32))
        for _ in range(2):
            _, loss = step(state, torch.Generator().manual_seed(1), batch[rows(8)])
            _, want_loss = one(single, torch.Generator().manual_seed(1), batch)
        if rules is None:  # one rank of a data mesh: the one-device step's bits
            same_state(state, single)
            assert torch.equal(loss, want_loss)
        grads_compiled = entry == "sharded_step"
        assert recorded.count(("_train_body", grads_compiled)) >= 2
        assert recorded.count(("_train_body", True)) >= 2
    elif entry == "bench_train":
        from zedo_tpu_torch.tools import bench_train

        records = bench_train.main(["--rows", "8", "--steps", "1", "--dtype", "fp32",
                                    "--device", "cpu"])
        assert {"ms_per_step", "eager_ms_per_step"} <= set(records[0])
        assert ("_train_body", False) in recorded
    elif entry == "make_trained_fixture":
        from zedo_tpu_torch.tools import make_trained_fixture as mtf

        real = tlosses._train_body

        def stop(*args, **kw):
            real(*args, **kw)
            raise _Stop

        monkeypatch.setattr(tlosses, "_train_body", stop)
        monkeypatch.setattr(mtf, "model_config", lambda: tsm.ScoreMLPConfig(
            n_joints=17, hidden_dim=64, embed_dim=32, n_blocks=1, embedding_type="positional",
            dropout=0.0))
        with pytest.raises(_Stop):
            mtf.train_prior(CPU)
        want = {"stop"}
    elif entry == "run_sample_pc":
        _sample_cli(tmp_path, "--num", "4", "--override", "model.num_scales=10",
                    "--guide", "sym")
        want = {"_pc_body"}
    elif entry == "run_sample_ode":
        monkeypatch.setattr(tode.ODESampler, "__init__", _loose_ode_init)
        out = _sample_cli(tmp_path, "--num", "2", "--sampler", "ode")
        assert out["nfe"] > 0
        want = {"_rk45_body"}
    elif entry == "trainer_eval_sampling":
        rng = np.random.RandomState(1)

        class Held:
            db_3d = rng.randn(40, 17, 3).astype(np.float32) * 0.1

        ttrainer.train_loop(_train_config(), FakeDS(rng), Held(), output_dir=str(tmp_path),
                            device="cpu",
                            model_cfg=tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32,
                                                         n_blocks=1, num_scales=10),
                            trainer_cfg=ttrainer.TrainerConfig(n_epochs=1, eval_freq=1,
                                                               micro_solve=False))
        want = {"_train_body", "_pc_body"}
    elif entry == "multi_hypothesis_eval":
        gt, preds = hypotheses()
        tev.multi_hypothesis_eval(preds, gt, protocol2=True)
        want = {"_align_first", "_align_second"}
    else:
        from zedo_tpu_torch.serving import ZeDOEstimator

        family = np.load(f"{tbt.FIXTURE}/family.npz")
        gt, k, px = tbt.make_scenes(family, 4)
        preset = presets.h36m(hidden_dim=int(family["hidden"]), embed_dim=int(family["embed"]))
        params = tsm.init_params(torch.Generator().manual_seed(0), preset.model_cfg,
                                 device="cpu")
        est = ZeDOEstimator(params=params, model_cfg=preset.model_cfg, sde=preset.sde,
                            sampler=preset.sampler, zcfg=preset.zcfg,
                            clusters=np.asarray(gt[:2]), device=CPU,
                            batch_bucket=4).with_schedule(10, ipo_iterations=5)
        est.predict(px, k)
        want = {"_rank_and_pack_body"}
    assert want <= {name for name, flag in recorded if flag}, recorded


def _loose_ode_init(self, sde, shape, denoise=False, rtol=1e-5, atol=1e-5, eps=1e-3,
                    score_coeff=1.0):
    """ODESampler at tolerances of 1e-2, to keep the CLI's CPU run short."""
    for name, value in (("sde", sde), ("shape", shape), ("denoise", denoise), ("rtol", 1e-2),
                        ("atol", 1e-2), ("eps", eps), ("score_coeff", score_coeff)):
        object.__setattr__(self, name, value)


# ------------------------------------------------------- (f) stands alone

CHANGED = ["zedo_tpu_torch.utils.compiled", "zedo_tpu_torch.diffusion.losses",
           "zedo_tpu_torch.diffusion.ema", "zedo_tpu_torch.diffusion.sampling",
           "zedo_tpu_torch.diffusion.ode", "zedo_tpu_torch.diffusion.score",
           "zedo_tpu_torch.diffusion.guidance", "zedo_tpu_torch.ops.procrustes",
           "zedo_tpu_torch.data.evaluation", "zedo_tpu_torch.serving",
           "zedo_tpu_torch.train.trainer", "zedo_tpu_torch.run.sample",
           "zedo_tpu_torch.tools.bench_train", "zedo_tpu_torch.tools.make_trained_fixture",
           "zedo_tpu_torch.models.score_mlp_cond", "zedo_tpu_torch.utils.checkpoint"]


@pytest.mark.parametrize("module", CHANGED)
def test_changed_modules_import_no_jax(module):
    """Each module this slice changed imports neither jax nor the JAX
    package."""
    tree = ast.parse(inspect.getsource(importlib.import_module(module)))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "optax", "zedo_tpu"}, names
