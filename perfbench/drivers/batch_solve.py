"""Batch mixes: a researcher scoring a split, whole solves back to back.

Each solve is a new set of mix["n"] scenes from the seed under
mix["hypotheses"] hypotheses: the compiled solve (`pipeline.solve_jit`, or
`infant.solve_infant_jit` for a configuration whose pipeline starts from
the rays), the evaluation (`data.evaluation.multi_hypothesis_eval`) of each
protocol of mix["evaluation"] against the scenes' ground truth, and the
poses (and the trace) copied to the host, as the CLIs end. A solve's poses
count as done when they are on the host; the work a solve is its n input
poses, each with all its hypotheses.

`correct`: after the window the reference solves mix["check"]["rows"] rows
drawn from the seed among all the window's solves, or all the rows of
mix["check"]["solves"] solves drawn so; each row's poses are compared, and
the evaluation of one drawn solve is recomputed from its poses.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import compare, harness, loop, program, roofline, scenes


def scene(run, index: int) -> dict:
    mix, cfg = run.mix, run.config
    joints = cfg["model"]["n_joints"]
    if mix["scenes"] == "infant":
        sc = scenes.infant(run.seed, index, mix["n"], mix["hypotheses"], joints)
        sc["conf"] = None
        return sc
    sc = scenes.h36m(run.seed, index, mix["n"], joints)
    sc["cluster"] = scenes.clusters(run.seed, mix["hypotheses"], joints)
    return sc


def run(run: harness.Run) -> harness.Outcome:
    from zedo_tpu_torch.data import evaluation
    from zedo_tpu_torch.models import score_mlp
    from zedo_tpu_torch.utils.profiling import Stopwatch
    from zedo_tpu_torch.zeroshot import infant, pipeline

    cfg, mix, dev = run.config, run.mix, run.device
    model_cfg, sde, sampler, zcfg = program.solver(cfg)
    params = program.params(run.seed, cfg, dev, cfg["model"]["weights"])
    n, s = mix["n"], mix["hypotheses"]
    rays_init = cfg["pipeline"]["init"] == "rays"
    stopwatch = Stopwatch() if run.trace else None
    forward = roofline.forward_flops(n * s, 1, cfg["model"])

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def solve(index: int, sw=None):
        sc = scene(run, index)
        with torch.no_grad():
            if rays_init:
                res = infant.solve_infant_jit(
                    params, score_mlp.apply, model_cfg, sde, sampler, zcfg, put(sc["cluster"]),
                    put(sc["px"]), put(sc["k"]), pelvis_mode=cfg["pipeline"]["pelvis"],
                    refine_t_from=cfg["pipeline"]["refine_t_from"], stopwatch=sw)
            else:
                res = pipeline.solve_jit(params, model_cfg, sde, sampler, zcfg,
                                         put(sc["cluster"]), put(sc["px"]), put(sc["conf"]),
                                         put(sc["k"]), stopwatch=sw)
            gt = put(sc["gt"])
            with loop.span(run, "eval") if sw is not None else contextlib.nullcontext():
                errors = {p: evaluation.multi_hypothesis_eval(
                    res.poses, gt, protocol2=p == "p2").per_sample_min
                    for p in mix["evaluation"]}
            poses = res.poses.cpu().numpy()
            trace = None if res.reproj_px is None else res.reproj_px.cpu().numpy()
        return {"poses": poses, "trace": trace, "errors": errors}

    for i in range(mix["warmup_units"]):
        solve(scenes.WARMUP_INDEX + i)

    def unit(i: int):
        out = solve(i, stopwatch)
        run.unit_work.append(n)
        run.unit_flops.append(zcfg.oil.iterations * forward)
        return out

    results = loop.measure(run, unit)
    run.rows_per_forward = n * s
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
    r = scenes.rng(run.seed, "sample")
    want = mix["check"]
    if "rows" in want:
        picks = np.stack([r.integers(0, len(results), want["rows"]),
                          r.integers(0, n, want["rows"]), r.integers(0, s, want["rows"])], 1)
    else:
        chosen = r.choice(len(results), size=min(want["solves"], len(results)), replace=False)
        grid = np.stack(np.meshgrid(np.arange(s), np.arange(n), indexing="ij"), -1).reshape(-1, 2)
        picks = np.concatenate([np.concatenate([np.full((len(grid), 1), c), grid[:, ::-1]], 1)
                                for c in chosen])
    sets = {int(u): scene(run, int(u)) for u in np.unique(picks[:, 0])}
    rows = {key: None if sets[picks[0, 0]][key] is None else
            np.stack([sets[u][key][i] for u, i, _ in picks]) for key in ("px", "k", "conf")}
    rows["cluster"] = np.stack([sets[u]["cluster"][h] for u, _, h in picks])
    got = np.stack([results[u]["poses"][i, h] for u, i, h in picks])
    p = program.reference_params(run.seed, cfg, dev, cfg["model"]["weights"])
    whole = "solves" in want
    groups = None
    if whole and cfg["pipeline"]["track_reproj"]:
        groups = (torch.as_tensor(picks[:, 2] + s * np.searchsorted(
            np.unique(picks[:, 0]), picks[:, 0])), s * len(sets))
    pipeline = compare.pipeline_of(cfg)
    expected, _, trace = compare.reference_rows(p, cfg["model"], pipeline, rows, n, dev, "f32",
                                                groups)
    out = {}
    if control:
        got, _, got_trace = compare.reference_rows(p, cfg["model"], pipeline, rows, n, dev, "fp8",
                                                   groups)
    else:
        got_trace = None
        if groups is not None:
            got_trace = np.concatenate([results[u]["trace"] for u in sets])
    out.update(compare.pose_numbers(compare.row_gaps_mm(got, expected)))
    if trace is not None:
        # the trace is a mean over rows of a pixel error that a few rows near
        # the camera plane dominate: its widest gap swings from seed to seed
        # (PERF.md, PR 16), its median relative gap over hypotheses and steps
        # does not
        out["trace_gap.median_rel"] = float(np.median(np.abs(got_trace - trace) / trace))
    u = int(picks[0, 0])
    gt = sets[u]["gt"]
    reported = (compare.control_evaluation(mix["evaluation"], results[u]["poses"], gt)
                if control else results[u]["errors"])
    out["eval_gap_mm.max"] = compare.evaluation_gap_mm(reported, results[u]["poses"], gt)
    return out
