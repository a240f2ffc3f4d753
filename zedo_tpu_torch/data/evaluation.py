"""Multi-hypothesis pose evaluation, batched on the device.

Port of zedo_tpu/data/evaluation.py. The whole [N, S] error matrix,
protocol-2 Procrustes alignment included (one batch of 3x3 SVDs), is
computed in f32 on the device of the predictions: a CUDA tensor keeps it on
the card, a numpy array or CPU tensor on the CPU. Only the reduced scalars
and the [N] vectors come back to the host for the action-wise report.

`multi_hypothesis_eval` computes the errors with `_hypothesis_errors_jit`
(JAX's jitted `_hypothesis_errors`), compiled calls keyed by the shapes,
protocol2, the joint subset and its order (utils/compiled.py): protocol 1 as
one, protocol 2 as procrustes.aligned_batched's two around the alignment's
SVD, the joint subset and the errors inside them. `_hypothesis_errors` runs
the same products eagerly, the oracle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from zedo_tpu_torch.ops.metrics import (
    auc_from_errors, joint_errors_mm, min_over_hypotheses, mpjpe, pck_from_errors,
)
from zedo_tpu_torch.ops.procrustes import aligned_batched, procrustes
from zedo_tpu_torch.utils import compiled as compiled_lib
from zedo_tpu_torch.utils import profiling
from zedo_tpu_torch.utils.table import Table


@dataclasses.dataclass
class EvalReport:
    error: float  # the headline metric (action-wise or plain mean of per-sample min)
    per_sample_min: np.ndarray  # [N]
    min_hypothesis: np.ndarray  # [N] argmin hypothesis index
    per_action: Optional[dict] = None  # action id -> mean error
    pck: Optional[float] = None
    auc: Optional[float] = None
    hypo_std: Optional[tuple] = None  # per-axis hypothesis std (x, y, z)


def _inputs(consts, *, subset_first: bool):
    """The predictions and the broadcast gt, on the subset where it comes
    before the alignment."""
    preds, gt, idx = consts["preds"], consts["gt"], consts["idx"]
    gt_b = gt[:, None].expand(preds.shape)
    if idx is not None and subset_first:
        preds, gt_b = preds[:, :, idx], gt_b[:, :, idx]
    return preds, gt_b


def _scored(consts, preds, gt_b, *, subset_first: bool):
    """The errors, on the subset where it comes after the alignment."""
    idx = consts["idx"]
    if idx is not None and not subset_first:
        preds, gt_b = preds[:, :, idx], gt_b[:, :, idx]
    return {"errors": mpjpe(preds, gt_b)}


def _errors_body(carry, consts, ys, counter, generator, variant, *, subset_first: bool):
    """Protocol 1's errors."""
    preds, gt_b = _inputs(consts, subset_first=subset_first)
    return _scored(consts, preds, gt_b, subset_first=subset_first)


def _consts(preds, gt, joint_subset) -> dict:
    idx = None if joint_subset is None else torch.as_tensor(joint_subset, device=preds.device)
    return {"preds": preds, "gt": gt, "idx": idx}


def _hypothesis_errors(preds, gt, protocol2: bool, joint_subset, subset_before_align):
    """[N, S, j, 3] preds vs [N, j, 3] gt -> [N, S] mean per-joint errors,
    eagerly: the oracle of `_hypothesis_errors_jit`."""
    consts = _consts(preds, gt, joint_subset)
    preds, gt_b = _inputs(consts, subset_first=subset_before_align)
    if protocol2:
        j, d = preds.shape[-2:]
        preds = procrustes(gt_b.reshape(-1, j, d), preds.reshape(-1, j, d)).z.reshape(
            preds.shape)
    return _scored(consts, preds, gt_b, subset_first=subset_before_align)["errors"]


def _hypothesis_errors_jit(preds, gt, protocol2: bool, joint_subset, subset_before_align):
    """`_hypothesis_errors` compiled."""
    consts = _consts(preds, gt, joint_subset)
    if not protocol2:
        out, _ = compiled_lib.step(
            functools.partial(_errors_body, subset_first=subset_before_align), None, consts,
            compiled=True)
        return out["errors"]
    return aligned_batched(consts, functools.partial(_inputs, subset_first=subset_before_align),
                           functools.partial(_scored, subset_first=subset_before_align))["errors"]


def _valid_mask(valid_ind, n: int, s: int) -> np.ndarray:
    """[N, S] boolean mask from an [N, S] boolean mask or per-sample rows
    (boolean mask rows or lists of valid hypothesis indices)."""
    vi = valid_ind
    if isinstance(vi, np.ndarray) and vi.dtype == bool and vi.shape == (n, s):
        return np.asarray(vi)
    rows = [np.asarray(list(vi[i])) for i in range(n)]
    if any(r.dtype == np.bool_ for r in rows):
        # boolean rows are per-sample masks, never index lists: casting
        # True/False to indices 1/0 would mark the wrong hypotheses valid
        if not all(r.dtype == np.bool_ and r.shape == (s,) for r in rows):
            raise ValueError(
                "valid_ind mixes boolean mask rows with index rows "
                f"(or a mask row is not length S={s}); supply either "
                "an [N, S] boolean mask or per-sample index lists")
        return np.stack(rows)
    mask = np.zeros((n, s), bool)
    lens = np.fromiter((len(r) for r in rows), dtype=np.int64, count=n)
    if lens.sum():
        flat = np.concatenate([r for r in rows if len(r)])
        if not np.issubdtype(flat.dtype, np.integer):
            fi = flat.astype(np.int64)
            if not np.array_equal(fi, flat):
                raise ValueError("valid_ind index rows must be integers")
            flat = fi
        mask[np.repeat(np.arange(n), lens), flat] = True
    return mask


def multi_hypothesis_eval(
    preds,
    gt,
    protocol2: bool = False,
    actions: Optional[np.ndarray] = None,
    action_order: Optional[Sequence[int]] = None,
    joint_subset=None,
    subset_before_align: bool = True,
    with_pck_auc: bool = False,
    with_hypo_std: bool = False,
    valid_ind=None,
) -> EvalReport:
    """Score [N, S, j, 3] hypotheses against [N, j, 3] GT.

    * per-sample error = min over hypotheses of mean per-joint error;
    * headline = mean over action groups of per-action means when `actions`
      is given, else the plain mean;
    * `joint_subset` restricts scored joints; `subset_before_align` says
      whether alignment sees the subset or the full pose;
    * `valid_ind`: an [N, S] boolean mask or per-sample rows of valid
      hypotheses; invalid hypotheses never win the min;
    * PCK/AUC on the min-error hypotheses; `hypo_std` the per-axis spread
      (ddof 0) of the root-relative hypotheses, root excluded.
    preds is a tensor (evaluated on its device) or an array (on the CPU).
    The span `zedo.evaluate`."""
    with profiling.annotate("zedo.evaluate"):
        preds = torch.as_tensor(preds, dtype=torch.float32)
        gt = torch.as_tensor(gt, dtype=torch.float32, device=preds.device)
        errors = _hypothesis_errors_jit(
            preds, gt, protocol2, None if joint_subset is None else tuple(joint_subset),
            subset_before_align)
        if valid_ind is not None:
            n, s = errors.shape
            mask = _valid_mask(valid_ind, n, s)
            if not mask.any(axis=1).all():
                raise ValueError("valid_ind leaves some sample with no valid hypothesis")
            errors = torch.where(torch.as_tensor(mask, device=errors.device), errors,
                                 torch.full_like(errors, float("inf")))
        min_err, min_arg = min_over_hypotheses(errors)
        per_sample_min = min_err.cpu().numpy()
        min_idx = min_arg.cpu().numpy()

        per_action = None
        if actions is not None:
            actions = np.asarray(actions)
            order = action_order if action_order is not None else sorted(set(actions.tolist()))
            per_action = {}
            means = []
            for a in order:
                sel = per_sample_min[actions == a]
                if len(sel):
                    per_action[a] = float(np.mean(sel))
                    means.append(per_action[a])
            if not means:
                raise ValueError(
                    f"no samples fall into any action of action_order="
                    f"{list(order)} (got actions {sorted(set(actions.tolist()))})")
            error = float(np.mean(means))
        else:
            error = float(np.mean(per_sample_min))

        pck = auc = None
        if with_pck_auc:
            min_preds = preds.gather(1, min_arg[:, None, None, None].expand(
                -1, 1, *preds.shape[2:]))[:, 0]
            err_mm = joint_errors_mm(gt, min_preds)  # one matrix feeds both metrics
            pck = pck_from_errors(err_mm)
            auc = auc_from_errors(err_mm)

        hypo_std = None
        if with_hypo_std:
            rel = (preds - preds[:, :, 0:1])[:, :, 1:]
            hypo_std = tuple(float(rel[..., ax].std(dim=1, correction=0).mean())
                             for ax in range(3))

        return EvalReport(error=error, per_sample_min=per_sample_min, min_hypothesis=min_idx,
                          per_action=per_action, pck=pck, auc=auc, hypo_std=hypo_std)


def gt_from_items(items) -> np.ndarray:
    """h36m-format pkl items -> root-centred GT in meters [N, j, 3] f32."""
    gt = np.array([i["joint_3d_camera"] for i in items], dtype=np.float64)
    return ((gt - gt[:, 0:1]) / 1000.0).astype(np.float32)


def actions_from_items(items) -> np.ndarray:
    return np.array([i["action"] for i in items])


def single_eval(preds, gt, protocol2: bool = False, actions: Optional[np.ndarray] = None,
                action_order: Optional[Sequence[int]] = None) -> EvalReport:
    """Single-hypothesis eval: per-sample error, optionally action-wise."""
    return multi_hypothesis_eval(preds[:, None], gt, protocol2=protocol2, actions=actions,
                                 action_order=action_order)


def print_action_table(title: str, protocol2: bool, per_action: dict, error: float):
    """The reference's action-wise report table."""
    table = Table([title] + [str(a) for a in per_action] + ["avg"])
    table.add_row(["p2" if protocol2 else "p1"]
                  + ["%.5f" % v for v in per_action.values()] + ["%.5f" % error])
    print(table)
