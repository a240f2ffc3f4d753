"""ZeDO-i's ControlNet adapter on the fast OIL path (ops/kernels/control_kernel.py,
zeroshot/oil.py) and its benchmark cell, on the CPU at small sizes on seeded
weights: kernel #3's plain version against the plain reference
(perfbench/reference/zedo_control.py), the fast path against the generic
path, the step tables, the yardstick's count, and the benchmark's cell of
the adapter (syrip.control_500x20).
Kernel #3 itself runs in tests/test_torch_gpu.py (`gpu`)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import harness, roofline, roofline_control, scenes, weights, weights_control
from perfbench.reference import zedo as ref
from perfbench.reference import zedo_control as ref_control
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import control_mlp, score_mlp, score_mlp_cond
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.ops.kernels import control_kernel as ck
from zedo_tpu_torch.zeroshot import infant, ipo, oil, pipeline

NEW_CELLS = ["syrip.control_500x20"]


def spec(joints=12, hidden=128, embed=64, groups=32):
    return {"n_joints": joints, "joint_dim": 3, "hidden_dim": hidden, "embed_dim": embed,
            "n_blocks": 2, "embedding_type": "positional", "group_norm_groups": groups,
            "dropout": 0.1, "scale_by_sigma": False, "sigma_min": 0.01, "sigma_max": 50,
            "num_scales": 1000}


def port_cfg(s):
    return score_mlp.ScoreMLPConfig(n_joints=s["n_joints"], hidden_dim=s["hidden_dim"],
                                    embed_dim=s["embed_dim"],
                                    group_norm_groups=s["group_norm_groups"])


def flat_weights(s, seed=3):
    return weights_control.make(seed, s, "cpu")


def rows(n, s, seed=1):
    return torch.randn(n, s["n_joints"] * 3, generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------------------ the forward


@pytest.mark.parametrize("joints,hidden", [(12, 128), (17, 256), (12, 256)])
def test_plain_version_matches_the_reference_forward(joints, hidden):
    """Kernel #3's plain version on f32 packed weights at one t against the
    reference's control forward. rtol 2e-4 / atol 2e-5: the folded weights
    (zc_layer_2 pre_dense_copy, zc_b_1 b_dense1_copy) and the indicator
    GroupNorm sum in another order than the reference's f32 chain."""
    s = spec(joints, hidden)
    flat, cfg = flat_weights(s), port_cfg(s)
    params = weights.nested(flat)
    label = torch.tensor([0.37 * 999])
    packed = ck.pack_weights(params, cfg, dtype=torch.float32, gn_dtype=torch.float32)
    vecs = ck.step_vectors(params, cfg, score_mlp.time_embedding(params, cfg, label))[0]
    x = rows(33, s)
    got = ck.fused_control_forward(x, packed, vecs)
    want = ref_control.control_mlp(ref, flat, s, x, label)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_plain_version_in_bf16_stays_near_the_reference():
    """The card's precision: bf16 packed weights and operands, GroupNorm
    statistics in bf16. Within 5% of the output's largest magnitude: bf16
    keeps 8 bits, rounded on every layer's operands."""
    s = spec(12, 256)
    flat, cfg = flat_weights(s), port_cfg(s)
    params = weights.nested(flat)
    label = torch.tensor([0.05 * 999])
    packed = ck.pack_weights(params, cfg)
    vecs = ck.step_vectors(params, cfg, score_mlp.time_embedding(params, cfg, label))[0]
    x = rows(64, s)
    want = ref_control.control_mlp(ref, flat, s, x, label)
    got = ck.fused_control_forward(x, packed, vecs)
    assert (got - want).abs().max() < 0.05 * want.abs().max()


def test_the_reference_with_zero_bridges_is_the_plain_prior():
    """With every zc_* bridge zero the adapter's trunk is the plain prior,
    whatever its copy branch computes: bit-equal (each bridge adds +0.0)."""
    s = spec(17, 128)
    flat = flat_weights(s)
    for name in list(flat):
        if name.startswith("zc_"):
            flat[name] = torch.zeros_like(flat[name])
    x, labels = rows(20, s), torch.rand(20, generator=torch.Generator().manual_seed(4)) * 999
    got = ref_control.control_mlp(ref, flat, s, x, labels)
    assert torch.equal(got, ref.score_mlp(flat, s, x, labels))


def test_the_reference_forward_matches_the_port_model():
    """The reference's forward against the port's control_mlp.apply on the
    same leaves, per-row labels (rtol 1e-4 / atol 1e-5: f32, the port's
    GroupNorm through indicator products)."""
    s = spec(12, 128)
    flat = flat_weights(s)
    x = rows(24, s)
    labels = torch.rand(24, generator=torch.Generator().manual_seed(2)) * 999
    got = control_mlp.apply(weights.nested(flat), port_cfg(s), x.reshape(24, 12, 3), labels)
    torch.testing.assert_close(got.reshape(24, -1), ref_control.control_mlp(ref, flat, s, x, labels),
                               rtol=1e-4, atol=1e-5)


def test_step_tables_reproduce_the_per_row_forward():
    """The [steps, 6, H] control tables built once a solve, read at one step,
    give the per-row forward (control_mlp.apply with every row at that
    step's t). rtol 1e-4 / atol 1e-5: the folds sum in another order."""
    s = spec(12, 128)
    cfg = port_cfg(s)
    params = weights.nested(flat_weights(s, seed=8))
    sde = SubVPSDE(n=50, t_max=0.1)
    t = torch.linspace(sde.T, 0.01, 50)
    consts, forward = oil._fast_program(params, cfg, sde, t, oil.OILConfig(iterations=50),
                                        oil.FAST_MODELS[control_mlp.apply], "kernel3")
    assert consts["steps"].shape == (50, 6, 128) and forward is ck.fused_control_forward
    x = rows(16, s, seed=5)
    for i in (0, 17, 49):
        got = ck.fused_control_forward(x, consts["model"], consts["steps"][i])
        want = control_mlp.apply(params, cfg, x.reshape(16, 12, 3), t[i].expand(16) * 999)
        torch.testing.assert_close(got, want.reshape(16, -1), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ the OIL path


def _infant_solve(params, cfg, use_kernel, steps=24, frames=6, hyps=2):
    sc = scenes.infant(11, 0, frames, hyps, cfg.n_joints)
    sde = SubVPSDE(n=steps, t_max=0.1)
    zcfg = pipeline.ZeDOConfig(
        ipo=ipo.IPOConfig(iterations=8, keypoint_list=tuple(range(12)), rot_axes="xyz"),
        oil=oil.OILConfig(iterations=steps, track_reproj=True, use_kernel=use_kernel))
    return infant.solve_infant_jit(params, control_mlp.apply, cfg, sde, PCSampler(sde=sde, eps=0.01),
                                   zcfg, torch.as_tensor(sc["cluster"]),
                                   torch.as_tensor(sc["px"]), torch.as_tensor(sc["k"]),
                                   pelvis_mode="mean03", refine_t_from=500)


def test_fast_path_matches_the_generic_path(monkeypatch):
    """The adapter through the infant solve: forced onto the fast path (the
    plain version of kernel #3 on the CPU) against the generic path (one
    zedo_pc_step a step), which share one deterministic Euler step. 24
    steps; atol 2e-5 m on the poses (f32, the folds), 0.02 px on the trace
    (2e-5 m at 3 m seen at focal 2000 px is 0.013 px)."""
    s = spec(12, 128)
    cfg = port_cfg(s)
    params = weights.nested(flat_weights(s, seed=9))
    generic = _infant_solve(params, cfg, None)
    calls = []
    monkeypatch.setattr(PCSampler, "zedo_pc_step",
                        lambda *a, **k: calls.append(1) or (_ for _ in ()).throw(AssertionError))
    fast = _infant_solve(params, cfg, True)
    assert not calls
    torch.testing.assert_close(fast.poses, generic.poses, rtol=0, atol=2e-5)
    torch.testing.assert_close(fast.reproj_px, generic.reproj_px, rtol=0, atol=0.02)


def test_the_adapter_takes_the_generic_path_off_the_kernel():
    """f32 weights, or the CPU, leave the adapter on the generic path; the
    conditional model never leaves it; use_kernel names kernel #3."""
    s = spec(12, 128)
    cfg = port_cfg(s)
    params = weights.nested(flat_weights(s))
    assert oil.model_path(params, cfg, oil.OILConfig(), control_mlp.apply) == "generic"
    assert oil.model_path(params, cfg, oil.OILConfig(use_kernel=True),
                          control_mlp.apply) == "kernel3"
    assert oil.model_path(params, cfg, oil.OILConfig(use_kernel=True), score_mlp_cond.apply,
                          condition=torch.zeros(1)) == "generic"
    bf16 = tree_map(lambda a: a.to(torch.bfloat16), params)
    assert oil.model_path(bf16, cfg, oil.OILConfig(), control_mlp.apply) == "generic"
    assert ck.kernel_supports(port_cfg(spec(12, 1024, 512))) and not ck.kernel_supports(
        port_cfg(spec(12, 384, 64, 32)))


@pytest.mark.parametrize("network,use_kernel,extra,want", [
    ("prior", None, {}, "plain"), ("prior", True, {}, "kernel1"),
    ("prior", None, {"scale_by_sigma": True}, "generic"), ("control", None, {}, "generic"),
    ("control", True, {}, "kernel3"), ("control", False, {}, "generic"),
    ("cond", True, {"condition": True}, "generic")])
def test_model_path_names_the_oil_model(network, use_kernel, extra, want):
    """oil.model_path is the one choice of the OIL loop's model (run_oil,
    _fast_program): on the CPU in f32 the prior is plain and the adapter
    generic unless use_kernel forces a kernel; a conditioned or scale_by_sigma
    model is always generic; a kernel path is its FAST_MODELS entry's, which
    names its library."""
    s = spec(12, 128)
    cfg = port_cfg(s)
    if extra.get("scale_by_sigma"):
        cfg = dataclasses.replace(cfg, scale_by_sigma=True)
    params = weights.nested(flat_weights(s))
    apply = {"prior": score_mlp.apply, "control": control_mlp.apply,
             "cond": score_mlp_cond.apply}[network]
    condition = torch.zeros(1) if extra.get("condition") else None
    path = oil.model_path(params, cfg, oil.OILConfig(use_kernel=use_kernel), apply, condition)
    assert path == want
    model = oil.FAST_MODELS.get(apply)
    library = model.library if model is not None and path == model.kernel else None
    assert library == {"kernel1": "score_mlp", "kernel3": "score_mlp_control"}.get(want)


@pytest.mark.parametrize("device,want", [
    ("cuda", [{"score_mlp", "score_mlp_control", "ipo_step"}]), ("cpu", [])])
def test_prebuild_kernel_builds_every_library_a_solve_launches(device, want, monkeypatch):
    """pipeline.prebuild_kernel(mesh) builds, on a CUDA mesh's first rank
    first, every library that a solve on the card can launch (the fast
    models' kernels and IPO's step) in one build call; a CPU mesh builds
    nothing."""
    from types import SimpleNamespace

    from zedo_tpu_torch.ops.kernels import build
    from zedo_tpu_torch.parallel import collectives

    builds, firsts = [], []
    monkeypatch.setattr(build, "build", lambda names: builds.append(set(names)))
    monkeypatch.setattr(collectives, "main_first", lambda mesh, fn: firsts.append(mesh) or fn())
    mesh = SimpleNamespace(device=torch.device(device))
    pipeline.prebuild_kernel(mesh)
    assert builds == want and firsts == [mesh] * len(want)


def test_the_tables_span_and_phase_time_the_control_build():
    """The span zedo.oil.tables and the Stopwatch phase oil_tables wrap the
    adapter's table build once a solve; the plain prior has neither."""
    from zedo_tpu_torch.utils import profiling

    s = spec(12, 128)
    cfg = port_cfg(s)
    params = weights.nested(flat_weights(s))
    sc = scenes.infant(11, 0, 4, 2, 12)
    sde = SubVPSDE(n=6, t_max=0.1)
    zcfg = pipeline.ZeDOConfig(ipo=ipo.IPOConfig(iterations=3, keypoint_list=tuple(range(12))),
                               oil=oil.OILConfig(iterations=6, use_kernel=True))
    args = (cfg, sde, PCSampler(sde=sde, eps=0.01), zcfg, torch.as_tensor(sc["cluster"]),
            torch.as_tensor(sc["px"]), torch.as_tensor(sc["k"]))
    for apply, want in ((control_mlp.apply, 1), (score_mlp.apply, 0)):
        sw = profiling.Stopwatch()
        profiling.clear()
        with profiling.recording():
            infant.solve_infant(params, apply, *args, stopwatch=sw)
        names = [span.name for span in profiling.spans()]
        assert names.count("zedo.oil.tables") == want
        assert sw.counts.get("oil_tables", 0) == want and sw.counts["oil"] == 1


# ------------------------------------------------------------ the yardstick


def test_the_control_roofline_counts_the_published_dataflow():
    """3*C*H + (1 + 4n)*H^2 multiply-adds a row and E^2 + 2(1 + 2n)EH + nH^2
    a distinct time; the trunk's share is roofline.trunk_flops. Kernel #3's
    bound counts what it executes, 3*C*H + 3n*H^2 a row: 0.129 ms at 10,000
    rows, on operations (the published dataflow's would be 0.193)."""
    s = spec(12, 1024, 512)
    c, h, e, n = 36, 1024, 512, 2
    assert roofline_control.row_flops(10_000, s) == 2 * 10_000 * (3 * c * h + (1 + 4 * n) * h * h)
    assert roofline_control.time_flops(3, s) == 2 * 3 * (e * e + 2 * (1 + 2 * n) * e * h
                                                         + n * h * h)
    adapter = 2 * 10_000 * (c * h + (1 + 2 * n) * h * h)
    assert roofline_control.row_flops(10_000, s) - adapter == roofline.trunk_flops(10_000, s)
    assert roofline_control.kernel_flops(10_000, s) == 2 * 10_000 * (3 * c * h + 3 * n * h * h)
    bound, kind = roofline_control.kernel_bound_s(10_000, s)
    assert kind == "operations" and round(bound * 1e3, 3) == 0.129
    assert round(roofline_control.row_flops(10_000, s) / roofline.PEAK_FLOPS["bf16"] * 1e3,
                 3) == 0.193
    assert round(roofline.kernel_bound_s(10_000, s)[0] * 1e3, 3) == 0.086


def test_the_adapter_weights_are_independent_draws():
    """The trunk is weights.make's at the same seed; every adapter leaf is a
    draw of its own: no copy equals its trunk layer, no bridge is zero, and
    infant_cond lies in [-1, 1)."""
    s = spec(12, 128)
    flat = flat_weights(s, seed=2**40 + 7)
    trunk = weights.make(2**40 + 7, s, "cpu")
    assert all(torch.equal(flat[k], v) for k, v in trunk.items())
    assert set(flat) - set(trunk) == set(weights_control.adapter_shapes(s))
    for k in flat:
        if k.endswith("_copy.weight"):
            assert not torch.equal(flat[k], trunk[k.replace("_copy", "")])
        if k.startswith("zc_"):
            assert flat[k].abs().min() > 0
    assert flat["infant_cond"].abs().max() <= 1
    assert torch.equal(flat_weights(s, seed=5)["zc_layer_2.weight"],
                       flat_weights(s, seed=5)["zc_layer_2.weight"])


# ------------------------------------------------------------ the cell


@pytest.mark.parametrize("name", NEW_CELLS)
def test_the_harness_resolves_the_new_cells(name):
    """Each new cell's configuration, mix, driver, limits and metric readers
    are found by name, and its metrics are the ones the cell reports."""
    cell = harness.cell(name)
    assert (harness.HERE / "drivers" / f"{cell.mix['driver']}.py").is_file()
    assert cell.config["network"] == "control_mlp"
    assert {m["name"] for m in cell.end_to_end} == {"poses_per_s", "setup_s"}
    assert {"fused_control_forward_roofline.batch", "oil_tables_ms.control", "ipo_ms.batch",
            "oil_ms.batch", "eval_ms.batch", "device.idle_share.batch", "mfu.batch",
            "graph_capture_s.setup"} == {m["name"] for m in cell.per_layer}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    assert set(cell.limits) and all(np.isfinite(v) for v in cell.limits.values())


def tiny_cell(name: str) -> harness.Cell:
    """perfbench's tests' `tiny` cell with the batch mixes' sizes (n 6,
    hypotheses 3), which `tiny` gives only the mixes of `batch_solve`."""
    from perfbench.tests.test_perfbench_cells import tiny

    cell = tiny(name)
    cell.mix = {**cell.mix, **{k: v for k, v in (("n", 6), ("hypotheses", 3)) if k in cell.mix}}
    return cell


@pytest.mark.parametrize("name", NEW_CELLS)
def test_the_new_cells_run_on_the_cpu_and_a_moved_answer_is_not_correct(name, monkeypatch):
    """Each new cell end to end at a tiny size (`tiny_cell`, at most 6 x 3
    input rows a solve): `correct`; then with the program's poses moved by
    5 cm, not."""
    from perfbench.tests.test_perfbench_cells import CPU_INFO

    cell = tiny_cell(name)
    rows = cell.mix.get("n", np.inf) * cell.mix.get("hypotheses", np.inf)
    assert rows <= 6 * 3, f"{name}'s mix solves {rows} rows on the CPU: {cell.mix}"

    def run():
        return harness.execute(cell, 2**31 + 12345, 0.3, False, torch.device("cpu"),
                               time.perf_counter(), lambda: dict(CPU_INFO))

    result = run()
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in harness.cell(name).end_to_end}
    real_solve = infant.solve_infant_jit

    def moved_solve(*a, **k):
        res = real_solve(*a, **k)
        return res._replace(poses=res.poses + 0.05)

    monkeypatch.setattr(infant, "solve_infant_jit", moved_solve)
    assert run()["correct"] is False


@pytest.mark.parametrize("routed,device,want", [
    ("as_is", "cpu", "generic"),  # the CPU: the path named, not held
    ("as_is", "cuda", None),  # f32 weights on a card take the generic path
    ("kernel3", "cuda", "kernel3"),  # the configuration's path on a card
    ("unnamed", "cpu", None),  # a program without model_path (before kernel #3)
])
def test_the_control_driver_runs_only_the_configurations_path(routed, device, want, monkeypatch):
    """The control cell's driver holds the program to the configuration's
    OIL path on a card and exits with 2 before its set-up otherwise, so a
    program without kernel #3 fails the cell cleanly instead of measuring
    another path under its name."""
    driver = harness.load_module(harness.HERE / "drivers" / "batch_solve_control.py")
    config = harness.cell(NEW_CELLS[0]).config
    s = spec(12, 128)
    params = weights.nested(flat_weights(s, seed=9))
    if routed == "kernel3":
        monkeypatch.setattr(oil, "model_path", lambda *a, **k: "kernel3")
    elif routed == "unnamed":
        monkeypatch.delattr(oil, "model_path")
    args = (config, params, port_cfg(s), oil.OILConfig(), torch.device(device))
    if want is None:
        with pytest.raises(SystemExit) as exit_:
            driver.require_path(*args)
        assert exit_.value.code == 2
    else:
        assert driver.require_path(*args) == want
