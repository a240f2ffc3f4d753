"""zedo_tpu_torch infant models (models/control_mlp.py, models/score_mlp_cond.py)
against the JAX package's and the reference's committed golden, on the
same weights carried across by params_from_numpy and by .pth checkpoints.
Forwards agree within 2e-5 (f32 products summed in another order, as the
ScoreMLP's test holds them); the golden within its own 1e-4."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

from zedo_tpu.models import control_mlp as jcm
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.models import score_mlp_cond as jcond
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models import score_mlp_cond as tcond
from zedo_tpu_torch.utils import checkpoint as tckpt

TOL = 2e-5
B = 8


def cfgs(n_joints=17, hidden=128, embed=64, embedding_type="positional"):
    kw = dict(n_joints=n_joints, hidden_dim=hidden, embed_dim=embed,
              embedding_type=embedding_type)
    return jsm.ScoreMLPConfig(**kw), tsm.ScoreMLPConfig(**kw)


def carry(jparams):
    return tckpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def batch(n_joints, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, n_joints, 3).astype(np.float32)
    labels = ((rs.rand(B) * 0.099 + 0.001) * 999.0).astype(np.float32)
    return x, labels


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v.float() if torch.is_tensor(v) else v)


@pytest.mark.parametrize("n_joints,embedding_type", [(17, "positional"), (12, "positional"),
                                                     (17, "fourier")])
def test_control_apply_matches_jax(n_joints, embedding_type):
    jcfg, tcfg = cfgs(n_joints, embedding_type=embedding_type)
    jparams = jcm.init_params(jax.random.PRNGKey(2), jcfg)
    x, labels = batch(n_joints)
    want = jcm.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels))
    got = tcm.apply(carry(jparams), tcfg, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_control_matches_golden():
    """The reference Control_ScoreModelFC_Adv (12 joints, hidden 128) through
    its state dict, on the inputs of test_control_model_parity."""
    with np.load(os.path.join(GOLDEN_DIR, "test_control_model_parity.npz")) as z:
        ref = _unflatten({k: z[k] for k in z.files}, "ref")
    _, tcfg = cfgs(12)
    rs = np.random.RandomState(0)
    x = rs.randn(B, 12, 3).astype(np.float32)
    labels = (rs.rand(B).astype(np.float32) * 0.099 + 0.001) * 999.0
    params = tckpt.params_from_torch_state_dict(ref["sd"], tcfg, device="cpu")
    got = tcm.apply(params, tcfg, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), ref["want"], atol=1e-4, rtol=1e-4)
    trainable = {k.rsplit(".", 1)[0] for k, v in leaves(tcm.trainable_mask(params)) if v}
    assert trainable == {str(n).rsplit(".", 1)[0] for n in np.asarray(ref["trainable"])}


def test_control_with_zero_bridges_is_the_trunk():
    """The zc bridges are the only way into the trunk: zeroed, the adapter
    computes the plain ScoreMLP."""
    _, tcfg = cfgs()
    params = tcm.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    for name in params:
        if name.startswith("zc_"):
            params[name] = {k: torch.zeros_like(v) for k, v in params[name].items()}
    x, labels = batch(17)
    got = tcm.apply(params, tcfg, torch.from_numpy(x), torch.from_numpy(labels))
    want = tsm.apply(params, tcfg, torch.from_numpy(x), torch.from_numpy(labels))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_control_init_and_mask_match_jax():
    jcfg, tcfg = cfgs()
    jparams = jcm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tcm.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jl, tl = dict(leaves(jparams)), dict(leaves(tparams))
    assert {k: v.shape for k, v in tl.items()} == {k: v.shape for k, v in jl.items()}
    for name in tcm._copied_layers(tcfg):
        for leaf in ("weight", "bias"):
            np.testing.assert_array_equal(tl[f"{name}_copy.{leaf}"], tl[f"{name}.{leaf}"])
    assert dict(leaves(tcm.trainable_mask(tparams))) == dict(leaves(jcm.trainable_mask(jparams)))
    # the train path (dropout from the generator passed in; tests/test_torch_train.py)
    out = tcm.apply(tparams, tcfg, torch.zeros(2, 17, 3), torch.ones(2), train=True,
                    generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 17, 3) and torch.isfinite(out).all()


def cond_cases(n_joints, seed=1):
    rs = np.random.RandomState(seed)
    c2 = rs.randn(B, n_joints, 2).astype(np.float32)
    c3 = rs.randn(B, n_joints, 3).astype(np.float32)
    c3_flat = c3.copy()
    c3_flat[:3, :, 2] = 0  # rows without depth: masked as 2D conditions
    mask = (rs.rand(B, n_joints, 3) > 0.3).astype(np.float32)
    return {"2d": (c2, None, {}), "3d": (c3_flat, None, {}), "none": (None, None, {}),
            "mask": (c2, mask, {}), "null": (c3, None, {"force_null_condition": True})}


@pytest.mark.parametrize("n_joints", [17, 12])
@pytest.mark.parametrize("case", ["2d", "3d", "none", "mask", "null"])
def test_cond_apply_matches_jax(n_joints, case):
    jcfg, tcfg = cfgs(n_joints)
    jparams = jcond.init_params(jax.random.PRNGKey(3), jcfg)
    x, labels = batch(n_joints)
    cond, mask, kw = cond_cases(n_joints)[case]

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = jcond.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels), j(cond), j(mask),
                       **kw)
    got = tcond.apply(carry(jparams), tcfg, torch.from_numpy(x), torch.from_numpy(labels),
                      t(cond), t(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_cond_null_condition_and_guidance():
    jcfg, tcfg = cfgs()
    jparams = jcond.init_params(jax.random.PRNGKey(5), jcfg)
    params = carry(jparams)
    x, labels = batch(17)
    c2, _, _ = cond_cases(17)["2d"]
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    # condition=None is the dropout null, not raw zero keypoints
    none = tcond.apply(params, tcfg, xt, lt, None)
    null = tcond.apply(params, tcfg, xt, lt, torch.from_numpy(c2), force_null_condition=True)
    torch.testing.assert_close(none, null, rtol=0, atol=0)
    zeros = tcond.apply(params, tcfg, xt, lt, torch.zeros(B, 17, 2))
    assert (zeros - none).abs().max() > 1e-3
    want = jcond.classifier_free_apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels),
                                       jnp.asarray(c2), 1.5)
    got = tcond.classifier_free_apply(params, tcfg, xt, lt, torch.from_numpy(c2), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4 * TOL)
    for n in (17, 12):
        np.testing.assert_array_equal(tcond.part_mask_table(n), jcond.part_mask_table(n))
    assert tcond.CondMaskConfig() == tcond.CondMaskConfig(0.0, 0.0, 0.0)
    tparams = tcond.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {k: v.shape for k, v in leaves(tparams)} == {k: v.shape for k, v in leaves(jparams)}
    # the train path (condition masking and dropout; tests/test_torch_train.py)
    out = tcond.apply(params, tcfg, xt, lt, train=True,
                      generator=torch.Generator().manual_seed(0))
    assert out.shape == xt.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("model", ["control", "cond"])
def test_adapter_checkpoints_load_in_both_packages(model, tmp_path):
    """An adapter's params as a reference .pth (DataParallel prefix, the
    *_copy, zc_*, infant_cond and cond_embed.0 keys) load to the same tree
    through both packages' load_any_checkpoint, and compute the same."""
    jmod, tmod = (jcm, tcm) if model == "control" else (jcond, tcond)
    jcfg, tcfg = cfgs(12)
    jparams = jmod.init_params(jax.random.PRNGKey(7), jcfg)
    flat = {"module." + k: torch.from_numpy(np.array(v))
            for k, v in jckpt.tree_to_flat(jparams).items() if k != "sigmas"}
    path = str(tmp_path / f"{model}.pth")
    torch.save({"epoch": 1, "model_state_dict": flat, "ema": None, "step": 9}, path)
    tparams, step = tckpt.load_any_checkpoint(path, tcfg, device="cpu")
    jloaded, jstep = jckpt.load_any_checkpoint(path, jcfg)
    assert step == jstep == 9
    got, want = dict(leaves(tparams)), dict(leaves(jloaded))
    assert set(got) == set(want) == set(dict(leaves(jparams)))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].astype(got[key].dtype), err_msg=key)
    x, labels = batch(12)
    np.testing.assert_allclose(
        tmod.apply(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(labels)).numpy(),
        np.asarray(jmod.apply(jloaded, jcfg, jnp.asarray(x), jnp.asarray(labels))), atol=TOL)
