"""zedo_tpu_torch IPO against the JAX package, including hypotheses folded
into the batch (each keeps its own mean loss)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu.zeroshot import ipo as jipo
from zedo_tpu_torch.zeroshot import ipo as tipo


def _scene(seed, n=6, j=17):
    """A scene whose init pose is the true pose (as the JAX package's IPO
    parity test builds it), so the L1 fit is well conditioned."""
    rs = np.random.RandomState(seed)
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1000.0
    k[:, 0, 2] = k[:, 1, 2] = 500.0
    k[:, 2, 2] = 1.0
    pose = (rs.randn(n, j, 3) * 0.25).astype(np.float32)
    pose -= pose[:, 0:1]
    t = np.array([0.3, 0.0, 4.0], np.float32)
    px = np.einsum("bij,bnj->bni", k, pose + t)
    px = (px[..., :2] / px[..., 2:]).astype(np.float32)
    return pose, px, k


def _rot_z(pose, angle):
    c, s = np.cos(angle), np.sin(angle)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (pose @ r.T).astype(np.float32)


def _compare(got, want):
    for name in ("rot_mat", "translation", "quaternion", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("iterations", [5, 60])
def test_run_ipo_matches_jax(iterations):
    pose, px, k = _scene(iterations)
    jcfg = jipo.IPOConfig(iterations=iterations)
    tcfg = tipo.IPOConfig(iterations=iterations)
    want = jipo.run_ipo(jnp.asarray(pose), jnp.asarray(px), jnp.asarray(k), jcfg)
    got = tipo.run_ipo(torch.tensor(pose), torch.tensor(px), torch.tensor(k), tcfg)
    _compare(got, want)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=1e-3)
    t0_j = jipo.init_translation(jnp.asarray(px), jnp.asarray(k), 3.0)
    t0_t = tipo.init_translation(torch.tensor(px), torch.tensor(k), 3.0)
    np.testing.assert_allclose(t0_t.numpy(), np.asarray(t0_j), atol=1e-6)


def test_run_ipo_folded_hypotheses_keep_their_own_mean():
    """S = 2 hypotheses folded into one batch give each hypothesis the
    trajectory it has alone (a plain mean would scale its gradient by 1/2)."""
    pose_a, px, k = _scene(7)
    pose_b = _rot_z(pose_a, 0.3)
    cfg_j = jipo.IPOConfig(iterations=60)
    cfg_t = tipo.IPOConfig(iterations=60)
    want = [jipo.run_ipo(jnp.asarray(p), jnp.asarray(px), jnp.asarray(k), cfg_j)
            for p in (pose_a, pose_b)]
    got = tipo.run_ipo(torch.tensor(np.concatenate([pose_a, pose_b])),
                       torch.tensor(np.concatenate([px, px])),
                       torch.tensor(np.concatenate([k, k])), cfg_t, n_groups=2)
    n = len(px)
    for s in range(2):
        part = tipo.IPOResult(*(v[s * n:(s + 1) * n] for v in got[:4]), loss=None)
        _compare(part, want[s])
    # the folded loss is the sum of the hypotheses' own means
    np.testing.assert_allclose(got.loss.numpy(), sum(float(w.loss) for w in want), rtol=1e-3)
    with pytest.raises(ValueError, match="groups"):
        tipo.run_ipo(torch.tensor(pose_a[:5]), torch.tensor(px[:5]), torch.tensor(k[:5]),
                     cfg_t, n_groups=2)


def _far_scene(seed, n=6, j=17):
    """A scene whose init pose is a random cluster (as chip_smoke.py and
    bench.build_inputs draw them), far from the true pose, in float64."""
    rs = np.random.RandomState(seed)
    k = np.zeros((n, 3, 3))
    k[:, 0, 0] = k[:, 1, 1] = 1145.0
    k[:, 0, 2] = k[:, 1, 2] = 512.0
    k[:, 2, 2] = 1.0
    pose = rs.randn(n, j, 3) * 0.25
    pose -= pose[:, 0:1]
    t = np.array([0.0, 0.0, 4.5])
    px = np.einsum("bij,bnj->bni", k, pose + t)
    px = px[..., :2] / px[..., 2:]
    cluster = rs.randn(j, 3) * 0.25
    init = np.repeat((cluster - cluster[0])[None], n, 0)
    return init, px, k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_run_ipo_far_init_float64_matches_jax(seed):
    """From a far init, 60 steps in float64 agree to ~1e-12: the two are the
    same function, and the ~1e-2 drift between them in float32 is the L1
    loss under Adam amplifying f32 rounding, not a fault of the port."""
    init, px, k = _far_scene(seed)
    with jax.enable_x64():
        want = jipo.run_ipo(jnp.asarray(init), jnp.asarray(px), jnp.asarray(k),
                            jipo.IPOConfig(iterations=60))
        want = {n: np.asarray(getattr(want, n))
                for n in ("rot_mat", "translation", "quaternion", "scale")}
    got = tipo.run_ipo(torch.tensor(init), torch.tensor(px), torch.tensor(k),
                       tipo.IPOConfig(iterations=60))
    for name, w in want.items():
        assert w.dtype == np.float64
        g = getattr(got, name)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, atol=1e-9, rtol=0, err_msg=name)
