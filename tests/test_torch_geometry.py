"""zedo_tpu_torch geometry (linalg, camera, rotations, gradient field, OIL
geometry, SDE) against the JAX package on random scenes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu.diffusion import sde as jsde
from zedo_tpu.ops import camera as jcam
from zedo_tpu.ops import gradient_field as jgf
from zedo_tpu.ops import linalg as jla
from zedo_tpu.ops import rotations as jrot
from zedo_tpu.zeroshot import oil as joil
from zedo_tpu_torch.diffusion import sde as tsde
from zedo_tpu_torch.ops import camera as tcam
from zedo_tpu_torch.ops import gradient_field as tgf
from zedo_tpu_torch.ops import linalg as tla
from zedo_tpu_torch.ops import rotations as trot
from zedo_tpu_torch.zeroshot import oil as toil

ATOL = 1e-5


def _scene(seed, b=6, j=17):
    rs = np.random.RandomState(seed)
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = rs.uniform(900, 1200, b)
    k[:, 1, 1] = rs.uniform(900, 1200, b)
    k[:, 0, 2] = rs.uniform(400, 600, b)
    k[:, 1, 2] = rs.uniform(400, 600, b)
    k[:, 0, 1] = rs.uniform(-2, 2, b)  # a little skew
    k[:, 2, 2] = 1.0
    pose = (rs.randn(b, j, 3) * 0.25).astype(np.float32)
    t = np.stack([rs.uniform(-0.3, 0.3, b), rs.uniform(-0.3, 0.3, b),
                  rs.uniform(3, 6, b)], -1)[:, None].astype(np.float32)
    px = np.einsum("bij,bnj->bni", k, pose + t)
    px = (px[..., :2] / px[..., 2:]).astype(np.float32)
    conf = rs.uniform(-0.1, 1.1, (b, j)).astype(np.float32)
    return k, pose, t, px, conf


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("seed", [0, 1])
def test_linalg_matches_jax(seed):
    m = np.random.RandomState(seed).randn(8, 3, 3).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    b = np.random.RandomState(seed + 10).randn(8, 3).astype(np.float32)
    _close(tla.det3x3(_t(m)), jla.det3x3(jnp.asarray(m)), atol=1e-4)
    _close(tla.adjugate3x3(_t(m)), jla.adjugate3x3(jnp.asarray(m)), atol=1e-4)
    _close(tla.inv3x3(_t(m)), jla.inv3x3(jnp.asarray(m)))
    _close(tla.solve3x3(_t(m), _t(b)), jla.solve3x3(jnp.asarray(m), jnp.asarray(b)), atol=1e-4)
    _close(tla.solve3x3(_t(m), _t(b[..., None])),
           jla.solve3x3(jnp.asarray(m), jnp.asarray(b[..., None])), atol=1e-4)
    k = _scene(seed)[0]
    _close(tla.inv_intrinsics(_t(k)), jla.inv_intrinsics(jnp.asarray(k)))


def _per_entry_inverse_and_rotation(m, q):
    """inv3x3 and quaternion_to_matrix written entry by entry, as the JAX
    package writes them."""
    a, b, c, d, e, f, g, h, i = [m[..., r, s] for r in range(3) for s in range(3)]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], -1).reshape(m.shape)
    r, x, y, z = torch.unbind(q, -1)
    two_s = 2.0 / (q * q).sum(-1)
    rot = torch.stack((
        1 - two_s * (y * y + z * z), two_s * (x * y - z * r), two_s * (x * z + y * r),
        two_s * (x * y + z * r), 1 - two_s * (x * x + z * z), two_s * (y * z - x * r),
        two_s * (x * z - y * r), two_s * (y * z + x * r), 1 - two_s * (x * x + y * y)), -1)
    return det, adj, adj / det[..., None, None], rot.reshape(q.shape[:-1] + (3, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_batched_closed_forms_round_as_the_per_entry_formulas(dtype):
    """det3x3, adjugate3x3, inv3x3 and quaternion_to_matrix take a few
    batched launches, and each entry is the same products and sums as the
    per-entry formula: bit for bit, signed zeros included."""
    gen = torch.Generator().manual_seed(3)
    m = torch.randn(4, 5, 3, 3, generator=gen, dtype=dtype) * 10.0 ** torch.randint(
        -3, 4, (4, 5, 1, 1), generator=gen).to(dtype)
    q = torch.randn(4, 5, 4, generator=gen, dtype=dtype)
    q[..., 1:][q[..., 1:].abs() < 0.3] = 0.0
    det, adj, inv, rot = _per_entry_inverse_and_rotation(m, q)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    for got, want in [(tla.det3x3(m), det), (tla.adjugate3x3(m), adj), (tla.inv3x3(m), inv),
                      (trot.quaternion_to_matrix(q), rot)]:
        assert got.shape == want.shape
        assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits))


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_and_rotations_match_jax(seed):
    k, pose, t, px, _ = _scene(seed)
    _close(tcam.project(_t(pose + t), _t(k)), jcam.project(jnp.asarray(pose + t), jnp.asarray(k)),
           atol=1e-3, rtol=1e-6)  # pixels of ~1e3
    _close(tcam.backproject_rays(_t(px), _t(k)),
           jcam.backproject_rays(jnp.asarray(px), jnp.asarray(k)))
    q = np.random.RandomState(seed).randn(9, 4).astype(np.float32)
    _close(trot.quaternion_to_matrix(_t(q)), jrot.quaternion_to_matrix(jnp.asarray(q)))


@pytest.mark.parametrize("with_conf", [True, False])
def test_gradient_field_matches_jax(with_conf):
    k, pose, t, px, conf = _scene(3)
    rays = np.asarray(jcam.backproject_rays(jnp.asarray(px), jnp.asarray(k)))
    rx, ry = rays[..., 0], rays[..., 1]
    c = conf if with_conf else None
    w_j = jgf.confidence_weights(None if c is None else jnp.asarray(c), jnp.asarray(rx))
    w_t = tgf.confidence_weights(None if c is None else _t(c), _t(rx))
    _close(w_t, w_j)
    _close(tgf.clamp_confidence(_t(conf)), jgf.clamp_confidence(jnp.asarray(conf)))
    _close(tgf.normal_matrix(_t(rx), _t(ry), w_t),
           jgf.normal_matrix(jnp.asarray(rx), jnp.asarray(ry), w_j), atol=1e-4)
    _close(tgf.normal_rhs(_t(rx), _t(ry), w_t, _t(pose)),
           jgf.normal_rhs(jnp.asarray(rx), jnp.asarray(ry), w_j, jnp.asarray(pose)))
    unit = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    _close(tgf.perpendicular_distance(_t(pose + t), _t(unit)),
           jgf.perpendicular_distance(jnp.asarray(pose + t), jnp.asarray(unit)))
    tt = np.random.RandomState(4).randn(6, 3).astype(np.float32)
    _close(tgf.flip_negative_z(_t(tt)), jgf.flip_negative_z(jnp.asarray(tt)))


@pytest.mark.parametrize("with_conf", [True, False])
def test_oil_geometry_matches_jax(with_conf):
    k, pose, t, px, conf = _scene(5)
    c = conf if with_conf else None
    jgeo = joil.precompute_geometry(jnp.asarray(px), jnp.asarray(k),
                                    None if c is None else jnp.asarray(c))
    tgeo = toil.precompute_geometry(_t(px), _t(k), None if c is None else _t(c))
    for name in joil.Geometry._fields:
        _close(getattr(tgeo, name), getattr(jgeo, name), atol=1e-4, rtol=1e-4)
    t_j = joil.solve_translation_fast(jgeo, jnp.asarray(pose))
    t_t = toil.solve_translation_fast(tgeo, _t(pose))
    _close(t_t, t_j, atol=1e-4, rtol=1e-4)
    # the solve recovers the scene's translation from its exact projection
    np.testing.assert_allclose(t_t.numpy(), t, atol=1e-3)
    _close(toil.ray_gradient(tgeo, _t(pose), t_t), joil.ray_gradient(jgeo, jnp.asarray(pose), t_j),
           atol=1e-4)


def test_subvp_sde_matches_jax():
    js = jsde.SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
    ts = tsde.SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
    x = np.random.RandomState(0).randn(5, 17, 3).astype(np.float32)
    t = np.linspace(0.01, 0.1, 5).astype(np.float32)
    for got, want in zip(ts.sde(_t(x), _t(t)), js.sde(jnp.asarray(x), jnp.asarray(t))):
        _close(got, want)
    for got, want in zip(ts.marginal_prob(_t(x), _t(t)),
                         js.marginal_prob(jnp.asarray(x), jnp.asarray(t))):
        _close(got, want)
    for got, want in zip(ts.discretize(_t(x), _t(t)),
                         js.discretize(jnp.asarray(x), jnp.asarray(t))):
        _close(got, want)
    assert ts.T == js.T == 0.1
