"""Kernel #4's plain version (ops/kernels/ipo_kernel.py) against the
autograd step it replaces on the card, the path choice, and the kernel path
through `run_ipo` on the CPU. (The plain version against the JAX package:
tests/test_torch_ipo.py; the kernel itself: tests/test_torch_gpu.py.)"""
import functools

import numpy as np
import pytest
import torch

from zedo_tpu_torch.ops.kernels import ipo_kernel
from zedo_tpu_torch.zeroshot import ipo

# (rot_axes, keypoint_list, n_groups): h36m's, its hypotheses folded,
# SyRIP's, the ski config's
CASES = [("z", (0, 1, 4), 1), ("z", (0, 1, 4), 2), ("xyz", tuple(range(12)), 2),
         ("y", tuple(range(17)), 1)]
# max |closed form - autograd| over the largest |autograd| of the tensor:
# the same function with products and sums in another order
TOL = {torch.float32: 2e-5, torch.float64: 1e-13}


def _step_inputs(rot_axes, keys, dtype, rows=12, j=17):
    """A state mid-way through a solve. Rows 0-3: the scale beyond and at
    each clamp bound. Row 4: the identity rotation, scale 1 and exact
    coordinates, its even keys' residuals exactly 0."""
    rs = np.random.RandomState(len(keys) + len(rot_axes))
    pose = rs.randn(rows, j, 3) * 0.25
    t = rs.randn(rows, 1, 3) * 0.2 + [0.0, 0.0, 4.0]
    k = np.zeros((rows, 3, 3))
    k[:, 0, 0] = k[:, 1, 1] = 1000.0
    k[:, :2, 2] = 500.0
    k[:, 2, 2] = 1.0
    px = rs.rand(rows, j, 2) * 1000
    pose[4], t[4], k[4] = [0.5, -0.25, 0.0], [0.0, 0.0, 4.0], np.eye(3)
    px[4] = [0.125, -0.0625]
    px[4, 1::2] += 1.0
    params = {"rot_vect": 1 + 0.3 * rs.randn(rows, 1), "scale": 1 + 0.5 * rs.randn(rows, 1, 1)}
    params["scale"][:4, 0, 0] = [0.4, 0.5, 2.0, 2.5]
    params["rot_vect"][4], params["scale"][4] = 1.0, 1.0
    for a in rot_axes:
        params[f"rot_vect_{a}"] = 0.3 * rs.randn(rows, 1)
        params[f"rot_vect_{a}"][4] = 0.0
    mu = {n: 0.05 * rs.randn(*p.shape) for n, p in params.items()}
    nu = {n: 0.01 * np.abs(rs.randn(*p.shape)) for n, p in params.items()}

    def put(tree):
        if isinstance(tree, dict):
            return {n: put(v) for n, v in tree.items()}
        return torch.tensor(tree, dtype=dtype)

    return put(pose), put(px), put(t), put(k), put(params), put(mu), put(nu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("rot_axes,keys,n_groups", CASES, ids=["z3", "z3_s2", "xyz12_s2", "y17"])
def test_plain_step_matches_the_autograd_step(rot_axes, keys, n_groups, dtype):
    """One step of the plain version against `_ipo_body`'s autograd step
    from the same state: the new parameters and moments and the loss."""
    pose, px, t, k, params, mu, nu = _step_inputs(rot_axes, keys, dtype)
    kl = list(keys)
    cfg = ipo.IPOConfig(iterations=10, keypoint_list=keys, rot_axes=rot_axes)
    corrections = ipo.adam_corrections(10, dtype, torch.device("cpu"))
    counter = torch.tensor([3])

    def carry(loss):
        return {"params": {n: p.clone() for n, p in params.items()},
                "mu": {n: m.clone() for n, m in mu.items()},
                "nu": {n: v.clone() for n, v in nu.items()}, "loss": loss}

    step = functools.partial(ipo._ipo_body, ys={}, counter=counter, generator=None,
                             variant=None, cfg=cfg, n_groups=n_groups, reciprocal=False)
    want = step(carry(torch.zeros((), dtype=dtype)),
                {"pose": pose[:, kl], "target": px[:, kl], "t": t, "k": k,
                 "corrections": corrections}, path="autograd")
    got = step(carry(torch.zeros(len(pose), dtype=dtype)),
               {"packed": ipo_kernel.pack(pose[:, kl], px[:, kl], t, k),
                "corrections": corrections}, path="kernel")
    for part in ("params", "mu", "nu"):
        assert got[part].keys() == want[part].keys()
        for name, w in want[part].items():
            g = got[part][name]
            assert g.dtype == dtype and g.shape == w.shape
            err = (g - w).abs().max() / w.abs().max()
            assert err <= TOL[dtype], (part, name, float(err))
    loss = ipo_kernel.group_loss(got["loss"], n_groups, len(keys))
    assert abs(float(loss - want["loss"])) <= TOL[dtype] * float(want["loss"])
    # row 4: the residuals of its even joints are exactly 0, of its odd 1
    assert float(got["loss"][4]) == 2 * sum(j % 2 for j in keys)


@pytest.mark.parametrize("device,dtype,path", [
    ("cuda", torch.float32, "kernel"), ("cpu", torch.float32, "autograd"),
    ("cuda", torch.float64, "autograd"), ("cpu", torch.float64, "autograd"),
    ("cuda", torch.bfloat16, "autograd")])
def test_step_path_follows_device_and_dtype(device, dtype, path):
    assert ipo.step_path(torch.device(device), dtype) == path


@pytest.mark.parametrize("rot_axes,keys,n_groups", CASES[1:3], ids=["z3_s2", "xyz12_s2"])
def test_kernel_path_compiled_is_eager_and_launches_nothing_on_the_cpu(
        rot_axes, keys, n_groups, monkeypatch):
    """`run_ipo` on the kernel path (its plain version on the CPU): the
    compiled scan is the eager loop bit for bit, and no kernel launch is
    counted."""
    pose, px, t, k, *_ = _step_inputs(rot_axes, keys, torch.float32)
    cfg = ipo.IPOConfig(iterations=25, keypoint_list=keys, rot_axes=rot_axes, max_scale_t=8.0)
    monkeypatch.setattr(ipo, "step_path", lambda device, dtype: "kernel")
    before = ipo_kernel.launch_counts["ipo_step"]
    eager = ipo.run_ipo(pose, px, k, cfg, t=t, n_groups=n_groups)
    got = ipo.run_ipo(pose, px, k, cfg, t=t, n_groups=n_groups, compiled=True)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    assert eager.loss.shape == () and torch.isfinite(eager.loss)
    assert ipo_kernel.launch_counts["ipo_step"] == before


def test_ipo_step_refuses_other_devices():
    """A tensor that is not on the CPU never reaches the plain version; the
    kernel's library needs CUDA (no fallback)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            ipo_kernel.load_library()
    pose, px, t, k, params, mu, nu = _step_inputs("z", (0, 1, 4), torch.float32)
    meta = ipo_kernel.pack(pose[:, :3], px[:, :3], t, k).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ipo_kernel.ipo_step(meta, {"params": params, "mu": mu, "nu": nu}, None, None,
                            weight=1.0, lr=0.1, lo=0.5, hi=2.0, b1=ipo.B1, b2=ipo.B2,
                            eps=ipo.EPS)
