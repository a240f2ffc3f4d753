"""The comparisons that decide `correct`: the program's answers against the
plain reference's, and the control's in the program's place."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import zedo as ref


def pipeline_of(cfg: dict, schedule: dict = None) -> dict:
    """The reference's description of the solve."""
    p = cfg["pipeline"]
    return {"zedo": {**cfg["zedo"], **(schedule or {})}, "sde": cfg["sde"],
            "pelvis": p["pelvis"], "init": p["init"], "refine_t_from": p["refine_t_from"]}


def row_gaps_mm(poses: np.ndarray, expected: np.ndarray) -> np.ndarray:
    """Per row, the mean over joints of the distance between two [R, j, 3]
    pose sets, in millimetres."""
    return np.linalg.norm(poses.astype(np.float64) - expected, axis=-1).mean(-1) * 1000.0


# a row whose pose is this far from the reference's counts as far off
FAR_MM = 25.0


def pose_numbers(gaps_mm: np.ndarray) -> dict:
    """The numbers of `correct` on the rows' pose gaps: their median, and
    the share of rows over FAR_MM, which counts a fault in fewer than half
    of the rows, where the median passes. Rounding alone puts a few percent
    of rows metres off (PERF.md), so a limit on the share sits above them."""
    return {"pose_gap_mm.median": float(np.median(gaps_mm)),
            f"rows_over_{FAR_MM:g}mm.share": float(np.mean(gaps_mm > FAR_MM))}


def reference_rows(p, cfg, pipeline, rows: dict, group_rows: int, device, precision: str,
                   trace_groups=None, chunk: int = 16384):
    """The reference solve of the rows {cluster, px, k, conf} in chunks of
    rows (each row alone but for IPO's group count): numpy
    (poses, translations, trace or None)."""
    def put(a):
        return None if a is None else torch.as_tensor(a, device=device)

    n = len(rows["px"])
    if trace_groups is not None and n > chunk:
        raise ValueError("a trace is the mean of whole groups: solve them in one chunk")
    poses, trans, trace = [], [], None
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        x, t, tr = ref.solve_rows(
            p, cfg, pipeline, put(rows["cluster"][sl]), put(rows["px"][sl]), put(rows["k"][sl]),
            put(None if rows["conf"] is None else rows["conf"][sl]), group_rows, precision,
            None if trace_groups is None else (put(trace_groups[0]), trace_groups[1]))
        poses.append(x.double().cpu().numpy())
        trans.append(t.double().cpu().numpy())
        trace = None if tr is None else tr.double().cpu().numpy()
    return np.concatenate(poses), np.concatenate(trans), trace


def bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bfloat16, as float64."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def evaluation_gap_mm(reported: dict, poses: np.ndarray, gt: np.ndarray) -> float:
    """The widest gap, in mm, between the evaluation's per-sample errors
    (protocol name -> [N] metres, the least over hypotheses) and the
    reference's from the same poses."""
    return max(float(np.abs(value - ref.sample_errors(poses, gt, name == "p2")).max()) * 1e3
               for name, value in reported.items())


def control_evaluation(protocols, poses: np.ndarray, gt: np.ndarray) -> dict:
    """The evaluation's per-sample errors with its inputs and per-joint
    errors in bfloat16."""
    out = {}
    for name in protocols:
        preds = bf16(poses)
        gt_b = np.broadcast_to(bf16(gt)[:, None], preds.shape)
        if name == "p2":
            preds = bf16(ref.procrustes_aligned(preds, gt_b))
        out[name] = bf16(np.linalg.norm(preds - gt_b, axis=-1)).mean(-1).min(1)
    return out
