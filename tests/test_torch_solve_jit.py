"""The compiled solve (pipeline.solve_jit, infant.solve_infant_jit, the scans
of utils/compiled.py) on the CPU: bit-equal to the eager solve that runs the
same scan bodies, within test_torch_pipeline.py's tolerances of JAX's
pipeline.solve_jit, its per-step tables equal to the JAX scans' xs, its cache
keyed as jit's, and the entry points reaching it. On the CPU the compiled
scans run their steps eagerly on their static buffers; the CUDA graphs are
held to the eager solve on the card (tests/test_torch_gpu.py, chip_smoke.py
phase 5b)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu import bench_trained as jbt
from zedo_tpu.diffusion.sampling import PCSampler as JPCSampler
from zedo_tpu.diffusion.sde import SubVPSDE as JSubVPSDE
from zedo_tpu.zeroshot import ipo as jipo
from zedo_tpu.zeroshot import oil as joil
from zedo_tpu.zeroshot import pipeline as jpipe
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch.diffusion.sampling import PCSampler as TPCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE as TSubVPSDE
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.utils import compiled
from zedo_tpu_torch.zeroshot import infant as tinfant
from zedo_tpu_torch.zeroshot import ipo as tipo
from zedo_tpu_torch.zeroshot import oil as toil
from zedo_tpu_torch.zeroshot import pipeline as tpipe

IPO_ITERS, OIL_ITERS, N, S = 60, 25, 5, 2


@pytest.fixture(scope="module")
def fixture():
    jcfg, jparams, family = jbt.load_fixture()
    tcfg, tparams, _ = tbt.load_fixture(device="cpu")
    gt, k, px = tbt.make_scenes(family, N)
    clusters = tbt.make_hypothesis_clusters(family, S)
    return jcfg, jparams, tcfg, tparams, gt, k, px, clusters


def _args(fx, ipo_iters=20, oil_iters=20, bf16=False, sampler_kw=None, **oil_kw):
    """solve's arguments on the trained fixture at a short schedule."""
    _, _, tcfg, tparams, _, k, px, clusters = fx
    sde = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=oil_iters, t_max=0.1)
    sampler = TPCSampler(sde=sde, eps=0.01, **(sampler_kw or {}))
    zcfg = tpipe.ZeDOConfig(ipo=tipo.IPOConfig(iterations=ipo_iters),
                            oil=toil.OILConfig(iterations=oil_iters, **oil_kw))
    params = tree_map(lambda a: a.to(torch.bfloat16), tparams) if bf16 else tparams
    return (params, tcfg, sde, sampler, zcfg, torch.tensor(clusters), torch.tensor(px), None,
            torch.tensor(k))


def _equal(got, want):
    assert torch.equal(got.poses, want.poses)
    assert torch.equal(got.translations, want.translations)
    assert (got.reproj_px is None) == (want.reproj_px is None)
    if want.reproj_px is not None:
        assert torch.equal(got.reproj_px, want.reproj_px)


# ------------------------------------------------- (a) bit-equal to eager


@pytest.mark.parametrize("oil_kw", [
    {}, {"track_reproj": True}, {"score_reuse": 2}, {"fixed_t_steps": 0},
    {"fixed_t_steps": 19, "track_reproj": True}, {"fixed_t_steps": 20},
    {"score_reuse": 2, "fixed_t_steps": 7, "track_reproj": True},
    {"use_kernel": True, "track_reproj": True}, {"use_kernel": True, "score_reuse": 2}],
    ids=["default", "trace", "reuse2", "resolve_all", "n_fixed_last_step", "never_resolve",
         "reuse2_n_fixed_trace", "kernel_trace", "kernel_reuse2"])
def test_solve_jit_is_bit_equal_to_solve_fast_path(fixture, oil_kw):
    """The fast path, at the n_fixed boundaries (re-solving from step 0,
    from the last step, never) and at score_reuse 2 (up to four bodies),
    with and without the reprojection trace, fp32 and on the kernel path
    (bf16 weights; the kernel's plain version on the CPU)."""
    args = _args(fixture, bf16=oil_kw.get("use_kernel", False), **oil_kw)
    want = tpipe.solve(*args)
    for _ in range(2):  # the first call builds the entry, the second reuses it
        _equal(tpipe.solve_jit(*args), want)


@pytest.mark.parametrize("case", ["langevin", "reuse2_noise", "control", "cond"])
def test_solve_jit_is_bit_equal_to_solve_generic_path(fixture, case):
    """The generic path with a seeded generator: a Langevin corrector, a
    stochastic predictor at score_reuse 2, the ControlNet adapter, and the
    conditional adapter through the infant solve. The result and the
    generator's state after the call are eager's."""
    sampler_kw, oil_kw, model_apply, params = {"corrector": "langevin"}, {}, None, None
    if case == "reuse2_noise":
        sampler_kw, oil_kw = {"probability_flow": False}, {"score_reuse": 2}
    args = list(_args(fixture, sampler_kw=sampler_kw, track_reproj=True, **oil_kw))
    if case == "control":
        model_apply = tcm.apply
        args[0] = tcm.init_params(torch.Generator().manual_seed(3), args[1], device="cpu")
    results, states = [], []
    for solve in (tpipe.solve, tpipe.solve_jit, tpipe.solve_jit):
        gen = torch.Generator().manual_seed(5)
        if case == "cond":
            from zedo_tpu_torch.models import score_mlp_cond as tcond

            params = tcond.init_params(torch.Generator().manual_seed(4), args[1], device="cpu")
            fn = tinfant.solve_infant if solve is tpipe.solve else tinfant.solve_infant_jit
            px = args[6]
            res = fn(params, tcond.apply, args[1], args[2], args[3], args[4], args[5], px,
                     args[8], generator=gen, condition=px / 500.0 - 1.0)
        else:
            res = solve(*args, model_apply=model_apply, generator=gen)
        results.append(res)
        states.append(gen.get_state())
    for res, state in zip(results[1:], states[1:]):
        _equal(res, results[0])
        assert torch.equal(state, states[0])
    assert not torch.equal(states[0], torch.Generator().manual_seed(5).get_state())


def test_solve_infant_jit_is_bit_equal_to_solve_infant(fixture):
    """The plain prior through the infant solve (pelvis-ray init, the
    translation re-solved from step 950 of 1000's fraction), kernel path."""
    params, tcfg, sde, sampler, zcfg, clusters, px, _, k = _args(
        fixture, bf16=True, use_kernel=True, track_reproj=True)
    kw = dict(pelvis_mode="joint0", refine_t_from=950)
    want = tinfant.solve_infant(params, None, tcfg, sde, sampler, zcfg, clusters, px, k, **kw)
    got = tinfant.solve_infant_jit(params, None, tcfg, sde, sampler, zcfg, clusters, px, k, **kw)
    _equal(got, want)


# ------------------------------------------- (b) against JAX's solve_jit


def _jax_solve_jit(fx, bf16=False, **oil_kw):
    jcfg, jparams, _, _, _, k, px, clusters = fx
    sde = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=OIL_ITERS, t_max=0.1)
    sampler = JPCSampler(sde=sde, eps=0.01)
    zcfg = jpipe.ZeDOConfig(ipo=jipo.IPOConfig(iterations=IPO_ITERS),
                            oil=joil.OILConfig(iterations=OIL_ITERS, **oil_kw))
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams) if bf16 else jparams
    res = jpipe.solve_jit(params, jcfg, sde, sampler, zcfg, jnp.asarray(clusters),
                          jnp.asarray(px), None, jnp.asarray(k),
                          precision=None if bf16 else jax.lax.Precision.HIGHEST)
    return np.asarray(res.poses), np.asarray(res.translations)


def _torch_solve_jit(fx, bf16=False, **oil_kw):
    res = tpipe.solve_jit(*_args(fx, IPO_ITERS, OIL_ITERS, bf16=bf16, **oil_kw))
    return res.poses.numpy(), res.translations.numpy()


def test_solve_jit_matches_jax_solve_jit_fp32(fixture):
    gt = fixture[4]
    want_p, want_t = _jax_solve_jit(fixture)
    got_p, got_t = _torch_solve_jit(fixture)
    assert got_p.shape == (N, S, 17, 3) and got_t.shape == (N, S, 1, 3)
    np.testing.assert_allclose(got_p, want_p, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_t, want_t, atol=1e-4, rtol=1e-3)
    assert abs(tbt.best_mpjpe(got_p, gt) - tbt.best_mpjpe(want_p, gt)) < 0.1


def test_solve_jit_score_reuse_matches_jax_solve_jit(fixture):
    """score_reuse 2, at test_torch_pipeline.py's tolerance for it (IPO's
    far-init rounding amplified, less contracted by OIL)."""
    gt = fixture[4]
    want_p, _ = _jax_solve_jit(fixture, score_reuse=2)
    got_p, _ = _torch_solve_jit(fixture, score_reuse=2)
    np.testing.assert_allclose(got_p, want_p, atol=2e-3)
    assert abs(tbt.best_mpjpe(got_p, gt) - tbt.best_mpjpe(want_p, gt)) < 0.1


@pytest.mark.parametrize("gn_fp32", [False, True])
def test_solve_jit_kernel_path_bf16_matches_jax_solve_jit(fixture, gn_fp32):
    """The kernel path with bf16 weights (its plain version on the CPU)
    against JAX's Pallas kernel in interpret mode under jit."""
    gt = fixture[4]
    want_p, _ = _jax_solve_jit(fixture, bf16=True, use_pallas=True, pallas_interpret=True,
                               gn_fp32=gn_fp32)
    before = tsk.launch_counts["fused_score_forward"]
    got_p, _ = _torch_solve_jit(fixture, bf16=True, use_kernel=True, gn_fp32=gn_fp32)
    assert tsk.launch_counts["fused_score_forward"] == before  # CPU: no kernel launch
    assert np.isfinite(got_p).all()
    assert abs(tbt.best_mpjpe(got_p, gt) - tbt.best_mpjpe(want_p, gt)) < 0.5


# ------------------------------------ (c) the scans' xs against JAX's


class _Recorded(Exception):
    pass


def _record(monkeypatch, module, attr):
    """Replace module.attr (a scan) by a recorder that keeps its arguments
    and stops the solve there."""
    seen = {}

    def recorder(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        raise _Recorded

    monkeypatch.setattr(module, attr, recorder)
    return seen


def test_ipo_corrections_are_optax_bias_corrections():
    """IPO's table holds Adam's bias corrections of steps 1..n, the values
    JAX's optax.adam divides by (1 - decay ** count, count an int32 step,
    the power in f32). Ours are Python's double power rounded once to f32:
    an f32 power of the rounded decay is off by the decay's relative
    rounding times the step (1.29e-8 x 500 = 6.4e-6 for b2 = 0.999 at step
    500; 3.9e-6 measured), and by its own rounding (1.2e-7). In f64 they
    are the eager loop's Python floats exactly."""
    n = 500
    table = tipo.adam_corrections(n, torch.float32, torch.device("cpu")).numpy()
    count = jnp.arange(1, n + 1, dtype=jnp.int32)
    for col, decay in enumerate((tipo.B1, tipo.B2)):
        want = np.asarray(1 - decay ** count)
        assert want.dtype == np.float32
        bound = abs(float(np.float32(decay)) - decay) / decay * n + 1.2e-7
        np.testing.assert_allclose(table[:, col], want, rtol=0, atol=bound)
    f64 = tipo.adam_corrections(n, torch.float64, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(f64[:, 0], [1.0 - 0.9 ** s for s in range(1, n + 1)])
    np.testing.assert_array_equal(f64[:, 1], [1.0 - 0.999 ** s for s in range(1, n + 1)])


def test_ipo_scan_reads_its_corrections_by_the_counter(fixture, monkeypatch):
    """The IPO scan's per-step input is the corrections table, one row a
    step: the scan gets the table and no Python step values."""
    args = _args(fixture, ipo_iters=33)
    seen = _record(monkeypatch, tipo, "scan")
    with pytest.raises(_Recorded):
        tpipe.solve_jit(*args)
    body, schedule, carry, consts, ys = seen["args"]
    assert schedule == (None,) * 33 and ys == {}
    torch.testing.assert_close(consts["corrections"],
                               tipo.adam_corrections(33, torch.float32, torch.device("cpu")),
                               rtol=0, atol=0)
    assert seen["kwargs"]["compiled"] is True


@pytest.mark.parametrize("kernel", [False, True])
def test_oil_scan_xs_match_jax(fixture, monkeypatch, kernel):
    """The fast path's per-step tables, c1, c2 and the step vectors (kernel
    path, bf16 weights) or the time embeddings, against the xs that JAX's
    _run_oil_fast hands its lax.scan, and its variants against JAX's
    resolve and eval masks. Both compute the tables from the same f32
    formulas, and the frameworks' exp, sin and cos round differently: c1 to
    1e-6 relative (2e-7 measured), c2 to 5e-6 (3.0e-6: 1 - exp cancels near
    t = 0), the time embeddings to 1e-6 absolute (1.5e-7), and the step
    vectors, f32 sums of 128 embedding products with bf16 weights, to 5e-5
    absolute (1.5e-5)."""
    jcfg, jparams, tcfg, tparams, _, k, px, _ = fixture
    steps, reuse = 40, 2
    oil_kw = dict(iterations=steps, score_reuse=reuse, fixed_t_steps=13)
    rows = torch.tensor(px).shape[0]
    x0 = np.zeros((rows, 17, 3), np.float32)
    t0 = np.tile(np.array([[[0.0, 0.0, 4.0]]], np.float32), (rows, 1, 1))
    sde_j = JSubVPSDE(beta_min=0.1, beta_max=20.0, n=steps, t_max=0.1)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams) if kernel else jparams
    jcfg_oil = joil.OILConfig(use_pallas=kernel, pallas_interpret=kernel, **oil_kw)
    seen_j = _record(monkeypatch, jax.lax, "scan")
    with pytest.raises(_Recorded):
        joil.run_oil(jp, jcfg, sde_j, JPCSampler(sde=sde_j, eps=0.01), jnp.asarray(x0),
                     jnp.asarray(t0), jnp.asarray(px), jnp.asarray(k), None, jcfg_oil)
    monkeypatch.undo()
    step_tables, c1, c2, resolve, eval_mask = (np.asarray(a) for a in seen_j["args"][2])

    sde_t = TSubVPSDE(beta_min=0.1, beta_max=20.0, n=steps, t_max=0.1)
    tp = tree_map(lambda a: a.to(torch.bfloat16), tparams) if kernel else tparams
    seen_t = _record(monkeypatch, toil, "scan")
    with pytest.raises(_Recorded):
        toil.run_oil(tp, tcfg, sde_t, TPCSampler(sde=sde_t, eps=0.01), torch.tensor(x0),
                     torch.tensor(t0), torch.tensor(px), torch.tensor(k), None,
                     toil.OILConfig(use_kernel=kernel, **oil_kw))
    body, schedule, carry, consts, ys = seen_t["args"]
    np.testing.assert_allclose(consts["c1"].numpy(), c1, rtol=1e-6, atol=0)
    np.testing.assert_allclose(consts["c2"].numpy(), c2, rtol=5e-6, atol=0)
    assert consts["steps"].shape == step_tables.shape
    np.testing.assert_allclose(consts["steps"].numpy(), step_tables.astype(np.float32),
                               rtol=0, atol=5e-5 if kernel else 1e-6)
    assert schedule == tuple(zip(resolve.tolist(), eval_mask.tolist()))
    assert isinstance(consts["model"], tsk.PackedScoreWeights) == kernel


# --------------------------------------------------------- (d) the cache


def test_cache_is_keyed_by_static_arguments_and_shapes(fixture):
    """One entry per scan (IPO, OIL) for the same shapes and configs; new
    params values of the same shapes reuse the entries and give the eager
    solve's new result; a changed static config or shape builds new ones."""
    compiled.clear_cache()
    args = list(_args(fixture))
    first = tpipe.solve_jit(*args)
    assert compiled.cache_info() == {"hits": 0, "misses": 2, "entries": 2}
    _equal(tpipe.solve_jit(*args), first)
    assert compiled.cache_info() == {"hits": 2, "misses": 2, "entries": 2}

    args[0] = tree_map(lambda a: a * 1.5, args[0])
    got = tpipe.solve_jit(*args)
    assert compiled.cache_info() == {"hits": 4, "misses": 2, "entries": 2}
    assert not torch.equal(got.poses, first.poses)
    _equal(got, tpipe.solve(*args))

    # a changed OIL config: a new OIL entry, the IPO entry reused
    args[4] = dataclasses.replace(args[4], oil=dataclasses.replace(args[4].oil, score_reuse=2))
    tpipe.solve_jit(*args)
    assert compiled.cache_info() == {"hits": 5, "misses": 3, "entries": 3}
    # a changed shape (one hypothesis fewer): new entries for both scans
    args[5] = args[5][:1]
    tpipe.solve_jit(*args)
    assert compiled.cache_info() == {"hits": 5, "misses": 5, "entries": 5}


def test_compiled_scan_returns_clones_and_keeps_callers_tensors():
    """A compiled scan's results are not its static buffers (a second call
    leaves the first's results as they were), and the caller's carry is not
    written."""
    import functools

    def body(carry, consts, ys, counter, generator, variant, *, scale):
        ys["trace"].index_copy_(0, counter, carry["x"][:1])
        return {"x": carry["x"] * scale + consts["add"].index_select(0, counter)[0]}

    compiled.clear_cache()
    step = functools.partial(body, scale=2.0)
    x0 = torch.ones(3)
    add = torch.arange(4.0)[:, None].expand(4, 3).contiguous()
    out1, ys1 = compiled.scan(step, (None,) * 4, {"x": x0}, {"add": add},
                              {"trace": torch.zeros(4)}, compiled=True)
    kept = out1["x"].clone(), ys1["trace"].clone()
    eager, eager_ys = compiled.scan(step, (None,) * 4, {"x": x0}, {"add": add},
                                    {"trace": torch.zeros(4)})
    torch.testing.assert_close(out1["x"], eager["x"], rtol=0, atol=0)
    torch.testing.assert_close(ys1["trace"], eager_ys["trace"], rtol=0, atol=0)
    out2, ys2 = compiled.scan(step, (None,) * 4, {"x": x0 * 3}, {"add": add},
                              {"trace": torch.zeros(4)}, compiled=True)
    assert torch.equal(out1["x"], kept[0]) and torch.equal(ys1["trace"], kept[1])
    assert not torch.equal(out2["x"], out1["x"])
    assert torch.equal(x0, torch.ones(3))
    assert compiled.cache_info()["entries"] == 1
    with pytest.raises(TypeError, match="functools.partial"):
        compiled.scan(lambda *a, **k: a[0], (None,), {"x": x0}, {}, {}, compiled=True)


# ------------------------------------------- (e) the entry points reach it


@pytest.fixture
def compiled_calls(monkeypatch):
    """Counts the calls of the compiled solves."""
    calls = {"solve_jit": 0, "solve_infant_jit": 0}
    for module, name in ((tpipe, "solve_jit"), (tinfant, "solve_infant_jit")):
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)
    return calls


def test_predict_reaches_solve_jit(fixture, compiled_calls, monkeypatch):
    from zedo_tpu_torch import presets
    from zedo_tpu_torch.serving import ZeDOEstimator

    _, _, tcfg, tparams, _, k, px, clusters = fixture
    preset = presets.h36m(hidden_dim=tcfg.hidden_dim, embed_dim=tcfg.embed_dim)
    est = ZeDOEstimator(params=tparams, model_cfg=tcfg, sde=preset.sde, sampler=preset.sampler,
                        zcfg=preset.zcfg, clusters=np.asarray(clusters), device=torch.device("cpu"),
                        batch_bucket=8).with_schedule(20, ipo_iterations=10)
    got = est.predict(px, k)
    assert compiled_calls["solve_jit"] == 1
    monkeypatch.setattr(tpipe, "solve_jit", tpipe.solve)
    want = est.predict(px, k)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_batch_cli_reaches_solve_jit(compiled_calls):
    """The batch CLI on the trained fixture at a short schedule solves
    through the compiled solve (its P1/P2 as its existing test holds them)."""
    from zedo_tpu_torch.run import opt_main

    fixture_dir = tbt.FIXTURE
    out = opt_main.main([
        "--config", "h36m", "--device", "cpu", "--gt", "--hypo", "2", "--strict_batch",
        "--ckpt_dir", f"{fixture_dir}/checkpoint", "--ckpt_name", "checkpoint_trained.pth",
        "--cluster_dir", f"{fixture_dir}/clusters", "--data_dir", f"{fixture_dir}/data",
        "--override", "model.hidden_dim=256", "--override", "model.embed_dim=128",
        "--override", "ZeDO.sample=1", "--override", "ZeDO.batch=24",
        "--override", "ZeDO.IPO_iterations=40", "--override", "ZeDO.OIL_iterations=30"])
    assert 0 < out["p2"] <= out["p1"]
    assert compiled_calls["solve_jit"] == 1


@pytest.mark.parametrize("entry", ["bench", "validate_dtype", "trainer_eval"])
def test_tools_reach_solve_jit(entry, monkeypatch):
    """The headline bench, the dtype check and the trainer's eval micro-solve
    call the compiled solve (stopped at its first call: their full-width
    solves run in their own tests and on the card)."""
    seen = _record(monkeypatch, tpipe, "solve_jit")
    with pytest.raises(_Recorded):
        if entry == "bench":
            from zedo_tpu_torch import bench

            bench.main(["--n", "4", "--s", "2", "--oil", "10", "--device", "cpu"])
        elif entry == "validate_dtype":
            from zedo_tpu_torch.tools import validate_dtype

            validate_dtype.main(["--n", "4", "--hypo", "2", "--device", "cpu"])
        else:
            _trainer_eval_solve()
    assert seen["args"][1].hidden_dim == (64 if entry == "trainer_eval" else 1024)


def _trainer_eval_solve():
    """The trainer's eval micro-solve of a small random prior."""
    from zedo_tpu_torch.models import score_mlp as tsm
    from zedo_tpu_torch.train import trainer

    cfg = tsm.ScoreMLPConfig(hidden_dim=64, embed_dim=32)
    tcfg = trainer.TrainerConfig()
    gt = np.random.RandomState(0).randn(32, 17, 3).astype(np.float32) * 0.2
    scene = trainer._build_micro_scene(gt, tcfg.data_scale, 8, 0)
    solver = trainer._micro_solver(scene, tsm.apply, cfg, TSubVPSDE(), tcfg, torch.device("cpu"))
    solver(tsm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))


def test_infant_cli_reaches_solve_infant_jit(tmp_path, monkeypatch, compiled_calls):
    """run.opt_main_infant on the trained fixture's poses as MINI-RGBD frames
    (its existing test's workspace) solves through solve_infant_jit, and its
    result is the eager solve's."""
    import importlib.util
    import os

    from zedo_tpu_torch.run import opt_main_infant

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke.write_infant_fixture_workspace(str(tmp_path), tbt)
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "mini", "--device", "cpu", "--hypo", "1",
            "--ckpt_dir", f"{tbt.FIXTURE}/checkpoint", "--ckpt_name", "checkpoint_trained.pth",
            "--override", "model.hidden_dim=256", "--override", "model.embed_dim=128",
            "--override", "ZeDO.IPO_iterations=30", "--override", "ZeDO.OIL_iterations=40"]
    got = opt_main_infant.main(argv)
    assert compiled_calls["solve_infant_jit"] == 1
    monkeypatch.setattr(tinfant, "solve_infant_jit", tinfant.solve_infant)
    want = opt_main_infant.main(argv)
    assert torch.equal(got["poses"], want["poses"])
    np.testing.assert_array_equal(got["reproj_px"], want["reproj_px"])


# ------------------------------------------------------ (f) stands alone


def test_compiled_module_imports_no_jax():
    """utils/compiled.py, like the rest of the port, imports torch alone."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(compiled))
    names = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for alias in (node.names if isinstance(node, ast.Import) else [node])
             if getattr(alias, "name", None)}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not names & {"jax", "zedo_tpu", "jaxlib", "optax"}, names
