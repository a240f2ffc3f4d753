"""Serving, closed loop with one caller: a live pose pipeline that sends one
frame's detections and waits for the reply before it sends the next.

The estimator is `serving.ZeDOEstimator` with mix["bucket"] rows a bucket
over mix["hypotheses"] seeded clusters, re-discretized to mix["schedule"]
(`with_schedule`, as `low_latency()` does). Request i carries N_i poses,
N_i drawn from the seed on 1..mix["largest"] with P(N) ~ mix["ratio"]^(N-1),
new keypoints, confidences and intrinsics each. A request's latency runs
from the call of `predict` to its return, numpy outputs in hand.

`correct`: after the window mix["check"]["requests"] requests drawn from the
seed are solved again by the reference (IPO's mean over the bucket's rows,
as padded); each row's poses are compared, and the ranking is recomputed
from the program's own poses and translations.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import compare, harness, loop, program, roofline, scenes
from perfbench.reference import zedo as ref


def run(run: harness.Run) -> harness.Outcome:
    from zedo_tpu_torch import serving

    cfg, mix, dev = run.config, run.mix, run.device
    model_cfg, sde, sampler, zcfg = program.solver(cfg)
    joints, s = cfg["model"]["n_joints"], mix["hypotheses"]
    clusters = scenes.clusters(run.seed, s, joints)
    est = serving.ZeDOEstimator(
        params=program.params(run.seed, cfg, dev, cfg["model"]["weights"]), model_cfg=model_cfg,
        sde=sde, sampler=sampler, zcfg=zcfg, clusters=clusters, device=dev,
        batch_bucket=mix["bucket"]).with_schedule(
            mix["schedule"]["OIL_iterations"], ipo_iterations=mix["schedule"]["IPO_iterations"])
    sizes = scenes.request_sizes(run.seed, mix["max_requests"], mix["largest"], mix["ratio"])
    oil = mix["schedule"]["OIL_iterations"]

    def request(index: int, n: int):
        sc = scenes.h36m(run.seed, index, n, joints)
        t = time.perf_counter()
        out = est.predict(sc["px"], sc["k"], sc["conf"])
        return out, (time.perf_counter() - t) * 1e3

    for i in range(mix["warmup_units"]):
        request(scenes.WARMUP_INDEX + i, mix["largest"])

    def unit(i: int):
        out, ms = request(i, int(sizes[i]))
        run.latencies_ms.append(ms)
        run.unit_work.append(int(sizes[i]))
        run.unit_flops.append(oil * roofline.forward_flops(int(sizes[i]) * s, 1,
                                                           cfg["model"]))
        return out

    results = loop.measure(run, unit)
    run.rows_per_forward = mix["bucket"] * s
    run.failed = sum(1 for r in results if not np.isfinite(r["poses"]).all())
    peak = loop.memory_peak(dev)
    del est
    program.free(dev)
    return harness.Outcome(
        check=lambda: check(run, results, sizes, clusters, False), memory_peak_bytes=peak,
        controls={"control": lambda: check(run, results, sizes, clusters, True)})


def check(run, results: list, sizes, clusters, control: bool) -> dict:
    """The numbers of `correct`. control: the reference in float8 solving
    in the program's place and the ranking in bfloat16."""
    cfg, mix, dev = run.config, run.mix, run.device
    s, bucket = mix["hypotheses"], mix["bucket"]
    joints = cfg["model"]["n_joints"]
    count = min(mix["check"]["requests"], len(results))
    chosen = np.sort(scenes.rng(run.seed, "sample").choice(len(results), count, replace=False))
    p = program.reference_params(run.seed, cfg, dev, cfg["model"]["weights"])
    pipeline = compare.pipeline_of(cfg, mix["schedule"])
    gaps, err_gaps, best_gap = [], [], 0.0
    # one reference call a padded size: IPO's mean runs over the bucket's rows
    by_rows = {}
    for i in chosen:
        by_rows.setdefault(-(-int(sizes[i]) // bucket) * bucket, []).append(int(i))
    for group_rows, ids in by_rows.items():
        sc = {i: scenes.h36m(run.seed, i, int(sizes[i]), joints) for i in ids}
        picks = [(i, n, h) for i in ids for h in range(s) for n in range(int(sizes[i]))]
        rows = {key: np.stack([sc[i][key][n] for i, n, _ in picks])
                for key in ("px", "k", "conf")}
        rows["cluster"] = np.stack([clusters[h] for _, _, h in picks])
        expected, _, _ = compare.reference_rows(p, cfg["model"], pipeline, rows, group_rows, dev,
                                                "f32")
        if control:
            got, _, _ = compare.reference_rows(p, cfg["model"], pipeline, rows, group_rows, dev,
                                               "fp8")
        else:
            got = np.stack([results[i]["poses"][n, h] for i, n, h in picks])
        gaps.append(compare.row_gaps_mm(got, expected))
        for i in ids:
            out = results[i]
            err = ref.reprojection_errors(out["poses"], out["translations"], sc[i]["px"],
                                          sc[i]["k"])
            reported = out["reprojection_error"]
            best = out["best"]
            if control:
                reported = compare.bf16(ref.reprojection_errors(
                    compare.bf16(out["poses"]), compare.bf16(out["translations"]),
                    compare.bf16(sc[i]["px"]), compare.bf16(sc[i]["k"])))
                best = reported.argmin(1)
            err_gaps.append((np.abs(reported - err) / err).ravel())
            least = err.min(1)
            best_gap = max(best_gap, float(((err[np.arange(len(err)), best] - least)
                                            / least).max()))
    return {**compare.pose_numbers(np.concatenate(gaps)),
            "rank_error_gap.median": float(np.median(np.concatenate(err_gaps))),
            "best_excess.max": best_gap}
