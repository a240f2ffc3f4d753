"""ZeDO-i's ControlNet adapter scoring a split (`run.opt_main_infant
--control`): whole infant solves back to back.

As drivers/batch_solve.py's infant mixes, with the adapter in the prior's
place: each solve is mix["n"] new synthetic infant frames from the seed
under mix["hypotheses"] hypotheses, `infant.solve_infant_jit` with
`control_mlp.apply` on the adapter's seeded weights
(perfbench/weights_control.py), the evaluation of each protocol of
mix["evaluation"], and the poses and the trace copied to the host. The
program's forwards are read from its own counter (kernel #3's
`launch_counts`) at the start of unit 0 and of unit mix["trace_units"], so
the traced units' forwards are known; a program without that counter gives
none.

`correct`: after the window the reference (perfbench/reference/zedo_control.py)
solves all rows of mix["check"]["solves"] solves drawn from the seed. Each
row's poses are compared; the trace's median relative gap runs over the
steps at which the reference's trace is finite (a row at the camera plane
makes it +inf at a step, and |got - inf| / inf is no number); the
evaluation of one drawn solve is recomputed from its poses.

The configuration is the adapter on the fast OIL path (its "oil_path",
kernel #3). On a card, a program that routes the adapter elsewhere, or
names no path (`zeroshot.oil.model_path`, which a program without kernel #3
lacks), does not run this configuration: the run exits with 2 before its
set-up and prints no result. On the CPU the path is not held (the harness's
tests run the plain kernels there on f32 weights), but the program has to
name one.
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from perfbench import compare, harness, loop, program, roofline_control, scenes, weights
from perfbench import weights_control
from perfbench.drivers import batch_solve
from perfbench.reference import zedo as ref
from perfbench.reference import zedo_control as ref_control


def forwards():
    """Kernel #3's forwards so far, or None where the program has no such
    counter."""
    try:
        from zedo_tpu_torch.ops.kernels import control_kernel
    except ImportError:
        return None
    return control_kernel.launch_counts["fused_control_forward"]


def require_path(cfg: dict, params, model_cfg, oil_cfg, device) -> str:
    """The OIL path the program takes for the adapter on these weights; on a
    card it has to be the configuration's "oil_path". Otherwise the run
    exits with 2."""
    from zedo_tpu_torch.models import control_mlp
    from zedo_tpu_torch.zeroshot import oil

    choose = getattr(oil, "model_path", None)
    path = None if choose is None else choose(params, model_cfg, oil_cfg, control_mlp.apply)
    if path is None or (device.type == "cuda" and path != cfg["oil_path"]):
        print(f"{cfg['name']} is the adapter on the OIL path {cfg['oil_path']!r}; this "
              f"program takes {path or 'a path it does not name'}", file=sys.stderr)
        raise SystemExit(2)
    return path


def run(run: harness.Run) -> harness.Outcome:
    from zedo_tpu_torch.data import evaluation
    from zedo_tpu_torch.models import control_mlp
    from zedo_tpu_torch.utils.profiling import Stopwatch
    from zedo_tpu_torch.zeroshot import infant

    cfg, mix, dev = run.config, run.mix, run.device
    model_cfg, sde, sampler, zcfg = program.solver(cfg)
    params = weights.nested(weights_control.make(run.seed, cfg["model"], dev,
                                                 program.dtype_of(cfg["model"]["weights"])))
    require_path(cfg, params, model_cfg, zcfg.oil, dev)
    n, s = mix["n"], mix["hypotheses"]
    stopwatch = Stopwatch() if run.trace else None
    forward = roofline_control.forward_flops(n * s, 1, cfg["model"])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def solve(index: int, sw=None):
        sc = batch_solve.scene(run, index)
        with torch.no_grad():
            res = infant.solve_infant_jit(
                params, control_mlp.apply, model_cfg, sde, sampler, zcfg, put(sc["cluster"]),
                put(sc["px"]), put(sc["k"]), pelvis_mode=cfg["pipeline"]["pelvis"],
                refine_t_from=cfg["pipeline"]["refine_t_from"], stopwatch=sw)
            gt = put(sc["gt"])
            with loop.span(run, "eval") if sw is not None else contextlib.nullcontext():
                errors = {p: evaluation.multi_hypothesis_eval(
                    res.poses, gt, protocol2=p == "p2").per_sample_min
                    for p in mix["evaluation"]}
            poses = res.poses.cpu().numpy()
            trace = res.reproj_px.cpu().numpy()
        return {"poses": poses, "trace": trace, "errors": errors}

    for i in range(mix["warmup_units"]):
        solve(scenes.WARMUP_INDEX + i)

    marks = {}

    def unit(i: int):
        if i in (0, mix["trace_units"]):
            marks[i] = forwards()
        out = solve(i, stopwatch)
        run.unit_work.append(n)
        run.unit_flops.append(zcfg.oil.iterations * forward)
        return out

    results = loop.measure(run, unit)
    run.rows_per_forward = n * s
    if run.traced_units and None not in marks.values() and len(marks) == 2:
        run.control_forwards_traced = marks[mix["trace_units"]] - marks[0]
    if stopwatch is not None:
        run.spans.update(stopwatch.totals)
    run.failed = sum(1 for r in results if not np.isfinite(r["poses"]).all())
    peak = loop.memory_peak(dev)
    del params
    program.free(dev)
    return harness.Outcome(check=lambda: check(run, results, False), memory_peak_bytes=peak,
                           controls={"control": lambda: check(run, results, True)})


def check(run, results: list, control: bool) -> dict:
    """The numbers of `correct`. control: the same numbers with the
    reference in float8 solving in the program's place and the evaluation
    in bfloat16."""
    cfg, mix, dev = run.config, run.mix, run.device
    n, s = mix["n"], mix["hypotheses"]
    chosen = scenes.rng(run.seed, "sample").choice(
        len(results), size=min(mix["check"]["solves"], len(results)), replace=False)
    sets = {int(u): batch_solve.scene(run, int(u)) for u in chosen}
    # rows hypothesis-major within each solve, as the trace's groups
    picks = [(u, i, h) for u in sets for h in range(s) for i in range(n)]
    rows = {key: torch.as_tensor(np.stack([sets[u][key][i] for u, i, _ in picks]), device=dev)
            for key in ("px", "k")}
    cluster = torch.as_tensor(np.stack([sets[u]["cluster"][h] for u, _, h in picks]), device=dev)
    groups = (torch.as_tensor(np.repeat(np.arange(s * len(sets)), n), device=dev), s * len(sets))
    p = {k: v.float() for k, v in weights_control.make(
        run.seed, cfg["model"], dev, program.dtype_of(cfg["model"]["weights"])).items()}
    pipeline = compare.pipeline_of(cfg)

    def reference(precision):
        x, _, trace = ref_control.solve_rows(ref, p, cfg["model"], pipeline, cluster, rows["px"],
                                             rows["k"], None, n, precision, groups)
        return x.double().cpu().numpy(), trace.double().cpu().numpy()

    expected, trace = reference("f32")
    if control:
        got, got_trace = reference("fp8")
    else:
        got = np.stack([results[u]["poses"][i, h] for u, i, h in picks])
        got_trace = np.concatenate([results[u]["trace"] for u in sets])
    out = compare.pose_numbers(compare.row_gaps_mm(got, expected))
    finite = np.isfinite(trace)
    out["trace_gap.median_rel"] = float(np.median(np.abs(got_trace[finite] - trace[finite])
                                                  / trace[finite]))
    u = int(chosen[0])
    gt = sets[u]["gt"]
    reported = (compare.control_evaluation(mix["evaluation"], results[u]["poses"], gt)
                if control else results[u]["errors"])
    out["eval_gap_mm.max"] = compare.evaluation_gap_mm(reported, results[u]["poses"], gt)
    return out
