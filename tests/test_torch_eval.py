"""zedo_tpu_torch evaluation (ops/procrustes, ops/metrics, data/evaluation)
against the JAX package on the same seeded numpy inputs, and against the
reference's committed goldens. Tolerance: 1e-5 relative to the largest
magnitude of the compared array (a pose's relative error, not each
coordinate's: an f32 coordinate near 0 carries the rounding of its
pose-sized terms) plus 1e-7 absolute (meters for poses); the same argmin
wherever hypotheses differ by more than 1e-5."""
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

from zedo_tpu.data import evaluation as jev
from zedo_tpu.ops import metrics as jmet
from zedo_tpu.ops import procrustes as jproc
from zedo_tpu_torch.data import evaluation as tev
from zedo_tpu_torch.ops import metrics as tmet
from zedo_tpu_torch.ops import procrustes as tproc

RTOL, ATOL = 1e-5, 1e-7


def golden(name):
    """The reference-side values of a committed parity golden."""
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files}, "ref")


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol + rtol * np.abs(want).max(), **kw)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def _pose_pairs(seed=0, n=6, j=17):
    """(a, b) pairs [n, j, 3]: b a rotated, scaled, shifted and noisy a."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, j, 3) * 0.25
    rot = np.stack([_rotation(rng) for _ in range(n)])
    b = (np.einsum("nij,nkj->nki", rot, a) * rng.uniform(0.5, 2.0, (n, 1, 1))
         + rng.randn(n, 1, 3) + rng.randn(n, j, 3) * 0.02)
    return a.astype(np.float32), b.astype(np.float32)


def _mirrored(seed=1, n=4):
    a, b = _pose_pairs(seed, n)
    return a, b * np.array([-1.0, 1.0, 1.0], np.float32)


def _near_collinear(seed=2, n=4, j=17, noise=1e-3):
    """Joints on a line with a little noise: one large singular value."""
    rng = np.random.RandomState(seed)
    t = rng.randn(n, j, 1)
    d = rng.randn(n, 1, 3)
    line = t * d + rng.randn(n, j, 3) * noise
    a, b = _pose_pairs(seed, n, j)
    return a, (line + rng.randn(n, 1, 3)).astype(np.float32)


def _jax_procrustes(a, b, scaling, reflection):
    fn = functools.partial(jproc.procrustes, scaling=scaling, reflection=reflection)
    return jax.vmap(fn)(jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("case", ["random", "mirrored", "near_collinear"])
@pytest.mark.parametrize("scaling", [True, False])
@pytest.mark.parametrize("reflection", ["best", True, False])
def test_procrustes_matches_jax(case, scaling, reflection):
    a, b = {"random": _pose_pairs, "mirrored": _mirrored,
            "near_collinear": _near_collinear}[case]()
    want = _jax_procrustes(a, b, scaling, reflection)
    got = tproc.procrustes(torch.tensor(a), torch.tensor(b), scaling=scaling,
                           reflection=reflection)
    # near-collinear joints leave two singular values 1e-3 apart: an f32 SVD
    # resolves the rotation off the line to ~1e-4 (in both packages), which
    # the aligned pose does not see but the rotation and translation do
    names = ("z", "scale") if case == "near_collinear" else ("z", "scale", "translation",
                                                             "rotation")
    for name in names:
        _close(getattr(got, name), getattr(want, name), err_msg=f"{case} {name}")
    # d is 1 - trace^2 (or 1 + ... - 2 ...) of unit-norm sets: its rounding is
    # relative to 1, not to the small residual
    _close(got.d, want.d, atol=RTOL)
    # the batch and one sample at a time are the same function
    one = tproc.procrustes(torch.tensor(a[0]), torch.tensor(b[0]), scaling=scaling,
                           reflection=reflection)
    _close(one.z, got.z[0])


def test_reflection_modes_pick_the_determinant():
    a, b = _mirrored()
    for reflection, sign in ((True, -1.0), (False, 1.0)):
        r = tproc.procrustes(torch.tensor(a), torch.tensor(b), reflection=reflection).rotation
        np.testing.assert_allclose(np.linalg.det(r.numpy()), sign, rtol=1e-5)
    # "best" keeps the SVD's rotation: a mirrored pose is matched by a reflection
    r = tproc.procrustes(torch.tensor(a), torch.tensor(b)).rotation
    assert (np.linalg.det(r.numpy()) < 0).all()


def test_collinear_pose_aligns_as_in_jax():
    """Exactly collinear predictions: a rank-one cross-covariance, whose
    null-space singular vectors are arbitrary; the aligned pose is not."""
    a, b = _near_collinear(noise=0.0)
    _close(tproc.align_to_gt(torch.tensor(b[0]), torch.tensor(a[0])),
           jproc.align_to_gt(jnp.asarray(b[0]), jnp.asarray(a[0])))
    _close(tproc.align_to_gt_batched(torch.tensor(b), torch.tensor(a)),
           jproc.align_to_gt_batched(jnp.asarray(b), jnp.asarray(a)))


def test_align_to_gt_batched_over_two_axes():
    rng = np.random.RandomState(3)
    gt = (rng.randn(5, 17, 3) * 0.3).astype(np.float32)
    preds = (gt[:, None] + rng.randn(5, 4, 17, 3) * 0.05).astype(np.float32)
    gt_b = np.broadcast_to(gt[:, None], preds.shape)
    _close(tproc.align_to_gt_batched(torch.tensor(preds), torch.tensor(np.ascontiguousarray(gt_b))),
           jproc.align_to_gt_batched(jnp.asarray(preds), jnp.asarray(gt_b)))


def test_metric_functions_match_jax():
    rng = np.random.RandomState(4)
    gt = (rng.randn(8, 3, 17, 3) * 0.3).astype(np.float32)
    pred = (gt + rng.randn(8, 3, 17, 3) * 0.05).astype(np.float32)
    tp, tg, jp, jg = torch.tensor(pred), torch.tensor(gt), jnp.asarray(pred), jnp.asarray(gt)
    _close(tmet.per_joint_error(tp, tg), jmet.per_joint_error(jp, jg))
    _close(tmet.mpjpe(tp, tg), jmet.mpjpe(jp, jg))
    _close(tmet.pa_mpjpe(tp, tg), jmet.pa_mpjpe(jp, jg))

    errors = rng.rand(20, 6).astype(np.float32)
    errors[3, [1, 4]] = errors[3].min() - 1.0  # a tie: the first index wins
    tmin, targ = tmet.min_over_hypotheses(torch.tensor(errors))
    jmin, jarg = jmet.min_over_hypotheses(jnp.asarray(errors))
    _close(tmin, jmin)
    np.testing.assert_array_equal(targ.numpy(), np.asarray(jarg))
    assert int(targ[3]) == 1

    gts = rng.randn(20, 17, 3) * 0.2
    preds = gts + rng.randn(20, 17, 3) * 0.08
    for joints in (None, [0, 3, 5, 16]):
        _close(tmet.joint_errors_mm(gts, preds, eval_joints=joints),
               jmet.joint_errors_mm(gts, preds, eval_joints=joints), rtol=1e-5, atol=1e-4)
        assert tmet.compute_pck(gts, preds, eval_joints=joints) == jmet.compute_pck(
            gts, preds, eval_joints=joints)
        assert tmet.compute_auc(gts, preds, eval_joints=joints) == jmet.compute_auc(
            gts, preds, eval_joints=joints)
    err = tmet.joint_errors_mm(gts, preds)
    assert tmet.pck_from_errors(err, 80.0) == jmet.pck_from_errors(
        jmet.joint_errors_mm(gts, preds), 80.0)
    x = rng.randn(40, 17, 3)
    q = rng.randn(5, 17 * 3)
    m_t, cov_t = tmet.mean_cov(x)
    m_j, cov_j = jmet.mean_cov(x)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(cov_t, cov_j)
    np.testing.assert_array_equal(tmet.mahalanobis(m=m_t, cov=cov_t, x=q),
                                  jmet.mahalanobis(m=m_j, cov=cov_j, x=q))


def test_metrics_golden():
    """The reference's compute_PCK/AUC/mean_cov/mahalanobis on the inputs of
    tests/test_reference_parity.py::test_metrics_parity."""
    rng = np.random.RandomState(0)
    gts = rng.randn(20, 17, 3) * 0.2
    preds = gts + rng.randn(20, 17, 3) * 0.08
    x = rng.randn(40, 17, 3).astype(np.float64)
    q = rng.randn(5, 17 * 3)
    want = golden("test_metrics_parity")
    np.testing.assert_allclose(tmet.compute_pck(preds, gts), want["pck"], rtol=1e-6)
    np.testing.assert_allclose(tmet.compute_auc(preds, gts), want["auc"], rtol=1e-6)
    m, cov = tmet.mean_cov(x)
    np.testing.assert_allclose(m, want["mean"], atol=1e-8)
    np.testing.assert_allclose(cov, want["cov"], atol=1e-8)
    np.testing.assert_allclose(tmet.mahalanobis(m=m, cov=cov, x=q), want["maha"], rtol=1e-6)


def _hypotheses(seed=5, n=30, s=5):
    rng = np.random.RandomState(seed)
    gt = (rng.randn(n, 17, 3) * 0.3).astype(np.float32)
    gt -= gt[:, 0:1]
    preds = (gt[:, None] + rng.randn(n, s, 17, 3) * 0.05).astype(np.float32)
    actions = np.array([2 + (i % 15) for i in range(n)])
    return gt, preds, actions


def _separated(preds, gt, protocol2=False, valid=None, joint_subset=None,
               subset_before_align=True, **_):
    """[N] True where JAX's best two hypotheses differ by more than 1e-5."""
    errors = np.array(jev._hypothesis_errors(
        jnp.asarray(preds), jnp.asarray(gt), protocol2,
        None if joint_subset is None else tuple(joint_subset), subset_before_align))
    if valid is not None:
        errors[~valid] = np.inf
    two = np.sort(errors, axis=1)[:, :2]
    return two[:, 1] - two[:, 0] > 1e-5


def _same_report(got, want, separated):
    np.testing.assert_allclose(got.error, want.error, rtol=RTOL)
    _close(got.per_sample_min, want.per_sample_min)
    assert separated.any()
    np.testing.assert_array_equal(got.min_hypothesis[separated],
                                  want.min_hypothesis[separated])
    assert (got.per_action is None) == (want.per_action is None)
    if want.per_action is not None:
        assert list(got.per_action) == list(want.per_action)
        _close(list(got.per_action.values()), list(want.per_action.values()))
    for name in ("pck", "auc"):
        if getattr(want, name) is None:
            assert getattr(got, name) is None
        else:
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=RTOL)
    if want.hypo_std is None:
        assert got.hypo_std is None
    else:
        np.testing.assert_allclose(got.hypo_std, want.hypo_std, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("protocol2", [False, True])
@pytest.mark.parametrize("variant", ["plain", "actions", "subset_before", "subset_after",
                                     "pck_auc_std"])
def test_multi_hypothesis_eval_matches_jax(protocol2, variant):
    gt, preds, actions = _hypotheses()
    kw = {
        "plain": {},
        "actions": dict(actions=actions, action_order=list(range(2, 17))),
        "subset_before": dict(joint_subset=[1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16],
                              subset_before_align=True),
        "subset_after": dict(joint_subset=[1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16],
                             subset_before_align=False),
        "pck_auc_std": dict(actions=actions, with_pck_auc=True, with_hypo_std=True),
    }[variant]
    _same_report(tev.multi_hypothesis_eval(preds, gt, protocol2=protocol2, **kw),
                 jev.multi_hypothesis_eval(preds, gt, protocol2=protocol2, **kw),
                 _separated(preds, gt, protocol2, **kw))


def test_hypo_std_is_the_population_std():
    """ddof 0 as jnp.std: torch.std's default (unbiased) would differ."""
    gt, preds, _ = _hypotheses(s=3)
    rel = (preds - preds[:, :, :1])[:, :, 1:]
    want = tuple(float(np.mean(np.std(rel[..., ax], axis=1))) for ax in range(3))
    got = tev.multi_hypothesis_eval(preds, gt, with_hypo_std=True).hypo_std
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_argmin_ties_take_the_first_hypothesis():
    gt, preds, _ = _hypotheses(n=6, s=4)
    preds[:, 2] = preds[:, 1]  # hypotheses 1 and 2 identical
    preds[:, 1] = gt  # ... and both the best
    preds[:, 2] = gt
    for ev in (tev, jev):
        assert (ev.multi_hypothesis_eval(preds, gt).min_hypothesis == 1).all()


@pytest.mark.parametrize("form", ["mask", "index_rows", "bool_rows"])
def test_valid_ind_forms_match_jax(form):
    gt, preds, actions = _hypotheses(n=12, s=4)
    rng = np.random.RandomState(6)
    mask = rng.rand(12, 4) < 0.5
    mask[np.arange(12), rng.randint(0, 4, 12)] = True
    valid = {"mask": mask,
             "index_rows": [list(np.flatnonzero(r)) for r in mask],
             "bool_rows": [list(r) for r in mask]}[form]
    for protocol2 in (False, True):
        _same_report(
            tev.multi_hypothesis_eval(preds, gt, protocol2=protocol2, valid_ind=valid,
                                      actions=actions),
            jev.multi_hypothesis_eval(preds, gt, protocol2=protocol2, valid_ind=valid,
                                      actions=actions),
            _separated(preds, gt, protocol2, valid=mask))
    got = tev.multi_hypothesis_eval(preds, gt, valid_ind=valid)
    assert mask[np.arange(12), got.min_hypothesis].all()


@pytest.mark.parametrize("valid, match", [
    ([[]] * 5, "no valid hypothesis"),
    ([[True, True, True]] * 4 + [[1, 2]], "mask"),
    ([[True, True]] * 5, "mask"),
    ([[1.5]] * 5, "integer"),
])
def test_valid_ind_errors_match_jax(valid, match):
    gt, preds, _ = _hypotheses(n=5, s=3)
    for ev in (tev, jev):
        with pytest.raises(ValueError, match=match):
            ev.multi_hypothesis_eval(preds, gt, valid_ind=valid)
    for ev in (tev, jev):
        with pytest.raises(ValueError, match="no samples fall"):
            ev.multi_hypothesis_eval(preds, gt, actions=np.full(5, 99), action_order=[2, 3])


def test_single_eval_gt_from_items_and_table(capsys):
    rng = np.random.RandomState(7)
    items = [{"joint_3d_camera": rng.randn(17, 3) * 250 + [0, 0, 4000], "action": 2 + i % 3}
             for i in range(9)]
    gt = tev.gt_from_items(items)
    np.testing.assert_array_equal(gt, jev.gt_from_items(items))
    assert gt.dtype == np.float32
    np.testing.assert_array_equal(tev.actions_from_items(items), jev.actions_from_items(items))
    preds = gt + (rng.randn(9, 17, 3) * 0.02).astype(np.float32)
    for protocol2 in (False, True):
        kw = dict(protocol2=protocol2, actions=tev.actions_from_items(items),
                  action_order=list(range(2, 17)))
        got, want = tev.single_eval(preds, gt, **kw), jev.single_eval(preds, gt, **kw)
        _same_report(got, want, np.ones(9, bool))
        tev.print_action_table("H36M", protocol2, got.per_action, got.error)
        t_out = capsys.readouterr().out
        jev.print_action_table("H36M", protocol2, want.per_action, want.error)
        assert t_out == capsys.readouterr().out


def test_h36m_eval_multi_golden(tmp_path):
    """The reference H36MDataset3D.eval_multi / eval themselves, on the
    inputs of tests/test_reference_parity.py::test_h36m_eval_multi_parity."""
    from zedo_tpu_torch.data.h36m import H36MDataset3D

    rng = np.random.RandomState(0)
    n, s = 30, 3
    items = []
    for i in range(n):
        pose = rng.randn(17, 3) * 250
        pose -= pose[0:1]
        items.append({
            "joint_3d_camera": pose + np.array([100.0, 50.0, 4000.0]),
            "joint_3d_image": rng.rand(17, 3) * 1000,
            "camera_param": dict(fx=1000.0, fy=1000.0, cx=500.0, cy=500.0),
            "image_path": f"{i}.jpg",
            "action": 2 + (i % 15),
        })
    with open(tmp_path / "h36m_test.pkl", "wb") as f:
        pickle.dump(items, f)
    gt = np.array([it["joint_3d_camera"] for it in items])
    gt = (gt - gt[:, 0:1]) / 1000.0
    preds = (gt[:, None] + rng.randn(n, s, 17, 3) * 0.05).astype(np.float32)

    want = golden("test_h36m_eval_multi_parity")
    mine = H36MDataset3D(str(tmp_path), "test", gt2d=True, abs_coord=True)
    for protocol2 in (False, True):
        w = want[f"p{int(protocol2) + 1}"]
        np.testing.assert_allclose(mine.eval_multi(preds, protocol2=protocol2), w["multi"],
                                   rtol=1e-5)
        np.testing.assert_allclose(mine.eval(preds[:, 0], protocol2=protocol2), w["single"],
                                   rtol=1e-5)


def test_pw3d_ski_3dhp_eval_multi_golden():
    """The reference PW3D / skiPose / MPII3DHP eval_multi themselves (PCK and
    AUC included), on the inputs of
    tests/test_reference_parity.py::test_pw3d_ski_3dhp_eval_multi_parity."""
    from zedo_tpu_torch.data.mpii3dhp import MPII3DHP
    from zedo_tpu_torch.data.pw3d import PW3D
    from zedo_tpu_torch.data.ski import skiPose

    rng = np.random.RandomState(0)
    n, s = 14, 3
    db_3d = rng.randn(n, 17, 3).astype(np.float32) * 0.3
    preds = ((db_3d - db_3d[:, 0:1])[:, None]
             + rng.randn(n, s, 17, 3) * 0.04).astype(np.float32)
    items = [{"joint_3d_camera": db_3d[i] * 1000 + np.array([0.0, 0.0, 4000.0]),
              "action": [15, 10, 17, 18, 19, 20, 21][i % 7]} for i in range(n)]
    want = golden("test_pw3d_ski_3dhp_eval_multi_parity")
    for name, cls in (("PW3D", PW3D), ("skiPose", skiPose)):
        mine = cls.__new__(cls)
        mine.db_3d = db_3d
        mine.subset = "test"
        for protocol2 in (False, True):
            np.testing.assert_allclose(mine.eval_multi(preds, protocol2=protocol2),
                                       want[name][f"p{int(protocol2) + 1}"], rtol=1e-5,
                                       err_msg=f"{name} protocol2={protocol2}")
    mine = MPII3DHP.__new__(MPII3DHP)
    mine.subset = "test"
    mine.gt_dataset = items
    mine.db_3d = np.array([it["joint_3d_camera"] / 1000.0 for it in items], np.float32)
    for protocol2 in (False, True):
        np.testing.assert_allclose(mine.eval_multi(preds, protocol2=protocol2),
                                   want["MPII3DHP"][f"p{int(protocol2) + 1}"], rtol=1e-5)
