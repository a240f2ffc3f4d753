"""zedo_tpu_torch dataset readers (data/h36m, mpii3dhp, pw3d, ski, custom)
against the JAX package's readers on the same synthetic files (the formats
of tests/test_data.py), and against the reference's committed reader
goldens. Arrays must be equal; evaluations agree within 1e-5 relative."""
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

import zedo_tpu.data as jdata
import zedo_tpu_torch.data as tdata
from zedo_tpu_torch.data import base as tbase

ARRAYS = ("db_2d", "db_3d", "camera_param")


def golden(name):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files}, "ref")


def _h36m(root, n=30, seed=0):
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        items.append({
            "joint_3d_camera": rng.randn(17, 3) * 300 + [0, 0, 4000],
            "joint_3d_image": rng.rand(17, 3) * 1000,
            "camera_param": {"fx": np.array(1145.0 + i), "fy": np.array(1144.0),
                             "cx": np.array(512.0), "cy": np.array(515.0)},
            "image_path": f"img_{i}.jpg",
            "action": 2 + (i % 15),
        })
    with open(os.path.join(root, "h36m_test.pkl"), "wb") as f:
        pickle.dump(items, f)
    dt = {"test": {"joint3d_image": rng.rand(n, 17, 3).astype(np.float32) * 1000,
                   "confidence": rng.rand(n, 17, 1).astype(np.float32)}}
    with open(os.path.join(root, "h36m_sh_dt_ft.pkl"), "wb") as f:
        pickle.dump(dt, f)
    return items


def _mpii3d(root, n=28, seed=1):
    rng = np.random.RandomState(seed)
    items = [{
        "joint_3d_camera": rng.randn(17, 3) * 300 + [0, 0, 3500],
        "joint_2d": rng.rand(17, 3) * 2000,
        "w": 2048, "h": 2048,
        "camera_param": {"fx": 1500.0 + i, "fy": 1500.0, "cx": 1017.0, "cy": 1043.0},
        "imageid": i, "valid_i": 1 if i % 3 else 0, "action": (i % 7) + 1,
    } for i in range(n)]
    with open(os.path.join(root, "mpii3d_test.pkl"), "wb") as f:
        pickle.dump(items, f)
    lens = {"TS1": 6, "TS2": 5, "TS3": 104, "TS4": 103, "TS5": 4, "TS6": 3}
    d3 = {s: rng.randn(k, 16, 3).astype(np.float32) * 300 for s, k in lens.items()}
    d2 = {s: rng.rand(k, 16, 2).astype(np.float32) * 2000 for s, k in lens.items()}
    np.savez(os.path.join(root, "mpii_dt_test.npz"), positions_3d=np.array(d3, dtype=object),
             positions_2d=np.array(d2, dtype=object))


def _pw3d(root, n=10, seed=2):
    rng = np.random.RandomState(seed)
    root_cam = np.zeros((n, 3), np.float32)
    root_cam[:, 2] = 5.0
    np.savez(os.path.join(root, "pw3d_test.npz"),
             keypoints3d17_relative=rng.randn(n, 17, 3).astype(np.float32) * 0.3,
             root_cam=root_cam,
             cam_param=np.array({"f": np.full((n, 2), 1000.0), "c": np.full((n, 2), 500.0)},
                                dtype=object),
             image_width=np.full(n, 1000), image_height=np.full(n, 1000),
             image_path=np.array([f"im{i}" for i in range(n)]))


def _ski(root, n=9, seed=3):
    import h5py

    rng = np.random.RandomState(seed)
    with h5py.File(os.path.join(root, "ski_test.h5"), "w") as f:
        f["seq"] = np.arange(n)
        f["cam"] = np.arange(n) % 3
        f["frame"] = np.arange(n)
        cam = np.zeros((n, 3, 3), np.float32)
        cam[:, 0, 0] = cam[:, 1, 1] = 4.0
        cam[:, 0, 2] = cam[:, 1, 2] = 0.5
        cam[:, 2, 2] = 1.0
        f["cam_intrinsic"] = cam
        f["3D"] = rng.randn(n, 17 * 3).astype(np.float32)
        f["2D"] = rng.rand(n, 17 * 2).astype(np.float32)


def _custom(root, n=5, seed=4):
    rng = np.random.RandomState(seed)
    np.savez(os.path.join(root, "custom_data.npz"),
             keypoints_2d=rng.rand(n, 17, 3).astype(np.float32),
             keypoints_3d=rng.randn(n, 17, 3).astype(np.float32),
             K=np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy(),
             image_name=np.array([f"f{i}" for i in range(n)]))


def _preds(ds, s=3, seed=5):
    rng = np.random.RandomState(seed)
    gt = ds.db_3d - ds.db_3d[:, 0:1]
    return (gt[:, None] + rng.randn(len(gt), s, 17, 3) * 0.05).astype(np.float32)


def _same_arrays(t, j, extra=()):
    for name in ARRAYS + tuple(extra):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                      np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(t.arrays()[0]), np.asarray(j.arrays()[0]))
    tc, jc = t.arrays()[1], j.arrays()[1]
    assert (tc is None) == (jc is None)
    if jc is not None:
        np.testing.assert_array_equal(tc, jc)


def _same_eval(t, j, preds, **kw):
    for protocol2 in (False, True):
        got = t.eval_multi(preds, protocol2=protocol2, **kw)
        want = j.eval_multi(preds, protocol2=protocol2, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"protocol2={protocol2}")


CASES = {
    # name: (file writer, dataset key, ctor kwargs, extra arrays)
    "h36m_gt2d": (_h36m, "h36m", dict(gt2d=True), ("actions",)),
    "h36m_gt2d_relative_strided": (_h36m, "h36m", dict(gt2d=True, abs_coord=False,
                                                        sample_interval=4), ("actions",)),
    "h36m_detected2d": (_h36m, "h36m", dict(gt2d=False), ("actions",)),
    "3dhp_gt2d": (_mpii3d, "3dhp", dict(gt2d=True, sample_interval=2), ()),
    "3dhp_detected2d": (_mpii3d, "3dhp", dict(gt2d=False), ()),
    "3dpw": (_pw3d, "3dpw", dict(gt2d=False), ("w", "h")),
    "ski": (_ski, "ski", dict(gt2d=True, sample_interval=2), ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reader_and_eval_match_jax(case, tmp_path, capsys):
    build, key, kw, extra = CASES[case]
    build(str(tmp_path))
    kw = {"abs_coord": True, **kw}
    t = tdata.DATASETS[key](str(tmp_path), "test", **kw)
    j = jdata.DATASETS[key](str(tmp_path), "test", **kw)
    _same_arrays(t, j, extra)
    assert len(t) == len(j)
    if hasattr(j, "gt_dataset") and j.gt_dataset is not None:
        assert [i["action"] for i in t.gt_dataset] == [i["action"] for i in j.gt_dataset]
    preds = _preds(j)
    _same_eval(t, j, preds)
    _same_eval(t, j, preds, sample_interval=2)
    # the printed tables (five decimals) are the same
    capsys.readouterr()
    t.eval_multi(preds, protocol2=True, print_verbose=True)
    t_out = capsys.readouterr().out
    j.eval_multi(preds, protocol2=True, print_verbose=True)
    j_out = capsys.readouterr().out
    table = [line for line in j_out.splitlines() if line[:1] in "+|"]
    assert [line for line in t_out.splitlines() if line[:1] in "+|"] == table
    if key == "h36m" or (key == "3dhp" and kw["gt2d"]):
        for protocol2 in (False, True):
            np.testing.assert_allclose(t.eval(preds[:, 0], protocol2=protocol2),
                                       j.eval(preds[:, 0], protocol2=protocol2), rtol=1e-5)


def test_eval_accepts_a_tensor_on_its_device(tmp_path):
    _h36m(str(tmp_path))
    ds = tdata.H36MDataset3D(str(tmp_path), "test", gt2d=True, abs_coord=True)
    preds = _preds(ds)
    assert ds.eval_multi(torch.from_numpy(preds), protocol2=True) == ds.eval_multi(
        preds, protocol2=True)


def test_custom_reader_matches_jax(tmp_path):
    _custom(str(tmp_path))
    t, j = tdata.CustomDataset(str(tmp_path)), jdata.CustomDataset(str(tmp_path))
    _same_arrays(t, j)
    assert t.image_name == j.image_name
    _same_eval(t, j, _preds(j))


def test_valid_ind_and_joint_subset_through_readers(tmp_path):
    _pw3d(str(tmp_path))
    t = tdata.PW3D(str(tmp_path), "test", gt2d=False, abs_coord=True)
    j = jdata.PW3D(str(tmp_path), "test", gt2d=False, abs_coord=True)
    preds = _preds(j, s=4)
    valid = [[1, 3]] * len(preds)
    _same_eval(t, j, preds, joint=14, valid_ind=valid)


def test_eval_gt_sources_match_jax(tmp_path):
    """3DPW's single-hypothesis eval: the h36m_test.pkl fallback, seq5678
    with a caller-set gt_dataset, and the error without one."""
    _pw3d(str(tmp_path), n=30)
    items = _h36m(str(tmp_path), n=30)
    gt = np.array([it["joint_3d_camera"] for it in items])
    preds = ((gt - gt[:, 0:1]) / 1000.0 + 0.02).astype(np.float32)
    for seq5678 in (False, True):
        t = tdata.PW3D(str(tmp_path), "test", gt2d=False, abs_coord=True, seq5678=seq5678)
        j = jdata.PW3D(str(tmp_path), "test", gt2d=False, abs_coord=True, seq5678=seq5678)
        if seq5678:
            with pytest.raises(ValueError, match="seq5678"):
                t.eval(preds)
            t.gt_dataset = j.gt_dataset = items
        np.testing.assert_allclose(t.eval(preds), j.eval(preds), rtol=1e-5)


def test_3dhp_single_eval_needs_the_gt_branch(tmp_path):
    _mpii3d(str(tmp_path))
    t = tdata.MPII3DHP(str(tmp_path), "test", gt2d=False, abs_coord=True)
    with pytest.raises(ValueError, match="GT pkl branch"):
        t.eval(t.db_3d)


def test_ski_reader_names_h5py_when_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tdata.skiPose(str(tmp_path), "test")


def test_helpers_and_registry_match_jax():
    rng = np.random.RandomState(6)
    data = rng.randn(6, 17, 3).astype(np.float32) * 100 + 500
    np.testing.assert_array_equal(tbase.flip_data(data), jdata.flip_data(data))
    np.testing.assert_array_equal(tbase.unflip_data(tbase.flip_data(data)),
                                  jdata.unflip_data(jdata.flip_data(data)))
    from zedo_tpu.data import base as jbase

    np.testing.assert_array_equal(tbase.normalize_data(data), jbase.normalize_data(data))
    np.testing.assert_array_equal(tbase.denormalize_data(data), jbase.denormalize_data(data))
    assert tbase.PoseDataset.get_skeleton() == jbase.PoseDataset.get_skeleton()
    # the adult readers and the infant ones
    assert set(tdata.DATASETS) == set(jdata.DATASETS)


def test_h36m_reader_golden(tmp_path):
    """The reference H36MDataset3D reader, on the fixture of
    tests/test_reference_parity.py::test_h36m_reader_parity."""
    rng = np.random.RandomState(0)
    items = []
    for i in range(9):
        pose = rng.randn(17, 3) * 250
        items.append({
            "joint_3d_camera": pose + np.array([100.0, 50.0, 4000.0]),
            "joint_3d_image": rng.rand(17, 3) * 1000,
            "camera_param": {k: np.float64(v) for k, v in dict(
                fx=1000.0 + i, fy=1001.0, cx=500.0, cy=501.0).items()},
            "image_path": f"{i}.jpg",
            "action": 2 + (i % 3),
        })
    with open(tmp_path / "h36m_test.pkl", "wb") as f:
        pickle.dump(items, f)
    want = golden("test_h36m_reader_parity")
    for vi, kw in enumerate([dict(gt2d=True, abs_coord=True),
                             dict(gt2d=True, abs_coord=False, sample_interval=2)]):
        mine = tdata.H36MDataset3D(str(tmp_path), "test", read_confidence=True, **kw)
        for name in ARRAYS:
            np.testing.assert_allclose(getattr(mine, name), want[f"v{vi}"][name], rtol=1e-6,
                                       err_msg=f"{kw} {name}")


def test_pw3d_reader_golden(tmp_path):
    """The reference PW3D reader, on the fixture of
    tests/test_reference_parity.py::test_pw3d_reader_parity."""
    rng = np.random.RandomState(0)
    n = 7
    kp3d = rng.randn(n, 17, 3).astype(np.float32) * 0.3
    root = np.zeros((n, 3), np.float32)
    root[:, 2] = 5.0
    np.savez(tmp_path / "pw3d_test.npz", keypoints3d17_relative=kp3d, root_cam=root,
             cam_param=np.array({"f": np.full((n, 2), 1000.0), "c": np.full((n, 2), 500.0)},
                                dtype=object),
             image_width=np.full(n, 1000), image_height=np.full(n, 1000),
             image_path=np.array([f"im{i}" for i in range(n)]))
    want = golden("test_pw3d_reader_parity")
    mine = tdata.PW3D(str(tmp_path), "test", gt2d=False, abs_coord=True)
    np.testing.assert_allclose(mine.db_3d, want["db_3d"], rtol=1e-5)
    np.testing.assert_allclose(mine.db_2d, want["db_2d"], rtol=1e-4)
    np.testing.assert_allclose(mine.camera_param, want["camera_param"], rtol=1e-6)


def test_ski_reader_golden(tmp_path):
    """The reference skiPose reader, on the fixture of
    tests/test_reference_parity.py::test_ski_reader_parity."""
    import h5py

    rng = np.random.RandomState(0)
    n, j = 5, 17
    with h5py.File(tmp_path / "ski_test.h5", "w") as f:
        f["3D"] = rng.randn(n, j, 3).astype(np.float32) * 0.3
        f["2D"] = rng.rand(n, j, 2).astype(np.float32)
        f["cam_intrinsic"] = np.tile(
            np.array([[4.0, 0, 0.5], [0, 4.0, 0.5], [0, 0, 1 / 256.0]], np.float32), (n, 1, 1))
        f["seq"] = np.zeros(n, np.int32)
        f["cam"] = np.zeros(n, np.int32)
        f["frame"] = np.arange(n)
    want = golden("test_ski_reader_parity")
    mine = tdata.skiPose(str(tmp_path), "test", gt2d=True, abs_coord=True)
    for name in ARRAYS:
        np.testing.assert_allclose(getattr(mine, name), want[name], rtol=1e-5, err_msg=name)
