"""zedo_tpu_torch fused score kernel: packing and the plain version against the
JAX package's Pallas kernel (interpret mode on the CPU). The CUDA kernel
itself is held against the plain version in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.ops.pallas import score_kernel as jsk
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.utils.checkpoint import params_from_numpy

T_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _setup(hidden, embed, seed=0):
    jcfg = jsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed)
    tcfg = tsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed)
    jparams = jsm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run_both(jcfg, tcfg, jparams, tparams, x, label, dtype, gn_dtype=None):
    """(jax interpret, torch plain) outputs of the fused forward on x [b, 51]."""
    b = x.shape[0]
    jpacked = jsk.pack_weights(jparams, jcfg, dtype=dtype, gn_dtype=gn_dtype)
    tpacked = tsk.pack_weights(tparams, tcfg, dtype=T_DT[dtype],
                               gn_dtype=None if gn_dtype is None else T_DT[gn_dtype])
    jtemb = jsm.time_embedding(jparams, jcfg, jnp.full((1,), label, jnp.float32))[0]
    ttemb = tsm.time_embedding(tparams, tcfg, torch.full((1,), label))[0]
    jvecs = jsk.step_vectors(jpacked, jtemb)
    tvecs = tsk.step_vectors(tpacked, ttemb)
    x_pad = jsk.pad_rows(jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - 51))), tile=128)
    want = np.asarray(jsk.fused_score_forward(x_pad, jpacked, jvecs, tile=128,
                                              interpret=True))[:b, :51]
    got = tsk.fused_score_forward(torch.from_numpy(x), tpacked, tvecs).numpy()
    return want, got


@pytest.mark.parametrize("dtype,gn_dtype", [(jnp.float32, None), (jnp.bfloat16, None),
                                            (jnp.bfloat16, jnp.float32)])
def test_pack_weights_matches_jax(dtype, gn_dtype):
    jcfg, tcfg, jparams, tparams = _setup(256, 128)
    jp = jsk.pack_weights(jparams, jcfg, dtype=dtype, gn_dtype=gn_dtype)
    tp = tsk.pack_weights(tparams, tcfg, dtype=T_DT[dtype],
                          gn_dtype=None if gn_dtype is None else T_DT[gn_dtype])
    atol = 1e-6 if dtype == jnp.float32 else 1e-2  # bf16: one rounding step
    for name in jsk.PackedScoreWeights._fields:
        jv, tv = getattr(jp, name), getattr(tp, name)
        pairs = zip(jv, tv) if name == "w_b" else [(jv, tv)]
        for a, b in pairs:
            assert b.dtype == T_DT[a.dtype.type], name
            np.testing.assert_allclose(b.float().numpy(), _f32(a), atol=atol, err_msg=name)
    assert tp.group_size == 256 // 32
    np.testing.assert_allclose(tp.gn_scale.numpy(), 1.0)


def test_plain_forward_matches_pallas_f32():
    jcfg, tcfg, jparams, tparams = _setup(256, 128)
    x = np.random.RandomState(0).randn(100, 51).astype(np.float32)
    want, got = _run_both(jcfg, tcfg, jparams, tparams, x, 47.3, jnp.float32)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("gn_dtype", [None, jnp.float32])
def test_plain_forward_matches_pallas_bf16(gn_dtype):
    jcfg, tcfg, jparams, tparams = _setup(256, 128)
    x = np.random.RandomState(1).randn(64, 51).astype(np.float32)
    want, got = _run_both(jcfg, tcfg, jparams, tparams, x, 12.0, jnp.bfloat16, gn_dtype)
    # the same products on the same bf16 operands; only the f32 summation
    # order differs, which can flip a bf16 rounding between layers
    err = np.abs(got - want) / (np.abs(want) + 1e-2)
    assert np.median(err) < 0.02, np.median(err)


def test_plain_forward_matches_apply_f32():
    jcfg, tcfg, jparams, tparams = _setup(256, 128)
    x = np.random.RandomState(2).randn(33, 17, 3).astype(np.float32)
    labels = np.full((33,), 47.3, np.float32)
    want = np.asarray(jsm.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels)))
    packed = tsk.pack_weights(tparams, tcfg, dtype=torch.float32)
    vecs = tsk.step_vectors(packed, tsm.time_embedding(tparams, tcfg, torch.full((1,), 47.3))[0])
    got = tsk.fused_score_forward(torch.from_numpy(x.reshape(33, 51)), packed, vecs)
    np.testing.assert_allclose(got.numpy().reshape(33, 17, 3), want, atol=5e-5, rtol=1e-4)


def test_plain_forward_full_width_matches_pallas():
    """The published width: hidden 1024, embed 512, 128 rows."""
    jcfg, tcfg, jparams, tparams = _setup(1024, 512)
    x = np.random.RandomState(3).randn(128, 51).astype(np.float32)
    want, got = _run_both(jcfg, tcfg, jparams, tparams, x, 47.3, jnp.float32)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    want, got = _run_both(jcfg, tcfg, jparams, tparams, x, 47.3, jnp.bfloat16, jnp.float32)
    err = np.abs(got - want) / (np.abs(want) + 1e-2)
    assert np.median(err) < 0.02, np.median(err)


def test_analytic_flops_and_pad_rows():
    for hidden in (128, 256, 1024):
        jcfg = jsm.ScoreMLPConfig(hidden_dim=hidden)
        tcfg = tsm.ScoreMLPConfig(hidden_dim=hidden)
        assert tsk.analytic_fwd_flops(44300, tcfg) == jsk.analytic_fwd_flops(44300, jcfg)
    assert tsk.pad_rows(torch.ones(100, 7), 64).shape == (128, 7)
    assert tsk.pad_rows(torch.ones(128, 7), 64).shape == (128, 7)


def test_kernel_supports_widths():
    assert tsk.kernel_supports(tsm.ScoreMLPConfig())
    assert tsk.kernel_supports(tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128))
    assert tsk.kernel_supports(tsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64))
    assert not tsk.kernel_supports(tsm.ScoreMLPConfig(hidden_dim=2048))  # groups of 64
    assert not tsk.kernel_supports(tsm.ScoreMLPConfig(hidden_dim=192))
    assert not tsk.kernel_supports(tsm.ScoreMLPConfig(n_blocks=3))
