"""zedo_tpu_torch ScoreMLP and checkpoint loading against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu import bench_trained as jax_bench_trained
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu_torch import bench_trained
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_from_torch_state_dict, strip_module_prefix,
)

CPU = "cpu"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(embedding_type):
    kw = dict(hidden_dim=128, embed_dim=64, embedding_type=embedding_type)
    return jsm.ScoreMLPConfig(**kw), tsm.ScoreMLPConfig(**kw)


@pytest.mark.parametrize("embedding_type", ["positional", "fourier"])
def test_apply_matches_jax_per_layer(embedding_type):
    jcfg, tcfg = _cfgs(embedding_type)
    jparams = jsm.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(_np_tree(jparams), device=CPU)
    rs = np.random.RandomState(0)
    x = rs.randn(6, 17, 3).astype(np.float32)
    labels = (rs.rand(6) * 99 + 1).astype(np.float32)

    jint, tint = {}, {}
    want = np.asarray(jsm.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels),
                                intermediates=jint))
    got = tsm.apply(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(labels),
                    intermediates=tint).numpy()
    assert set(jint) == set(tint)
    for name in jint:
        np.testing.assert_allclose(tint[name].numpy(), np.asarray(jint[name]),
                                   atol=2e-5, err_msg=name)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_time_embedding_matches_jax():
    jcfg, tcfg = _cfgs("positional")
    jparams = jsm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(_np_tree(jparams), device=CPU)
    labels = np.linspace(999 * 0.1, 999 * 0.01, 7).astype(np.float32)
    want = np.asarray(jsm.time_embedding(jparams, jcfg, jnp.asarray(labels)))
    got = tsm.time_embedding(tparams, tcfg, torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(tsm.get_sigmas(tcfg), jsm.get_sigmas(jcfg))


def test_params_from_numpy_round_trip():
    jcfg, _ = _cfgs("fourier")
    tree = _np_tree(jsm.init_params(jax.random.PRNGKey(0), jcfg))
    got = params_from_numpy(tree, device=CPU)
    flat_in = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_in) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_in:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    bf = params_from_numpy({"w": np.asarray(jnp.ones((2, 2), jnp.bfloat16))}, device=CPU)
    assert bf["w"].dtype == torch.bfloat16


def test_init_params_is_seeded_and_shaped():
    _, tcfg = _cfgs("positional")
    a = tsm.init_params(torch.Generator().manual_seed(0), tcfg, device=CPU)
    b = tsm.init_params(torch.Generator().manual_seed(0), tcfg, device=CPU)
    assert a["b2_dense2"]["weight"].shape == (128, 128)
    assert a["pre_dense"]["weight"].shape == (128, 51)
    torch.testing.assert_close(a["post_dense"]["weight"], b["post_dense"]["weight"])
    with pytest.raises(ValueError, match="size-1 groups"):
        tsm.ScoreMLPConfig(hidden_dim=32)


def test_trained_fixture_loads_to_the_same_outputs():
    jcfg, jparams, _ = jax_bench_trained.load_fixture()
    tcfg, tparams, _ = bench_trained.load_fixture(device=CPU)
    rs = np.random.RandomState(4)
    x = (rs.randn(5, 17, 3) * 0.2).astype(np.float32)
    labels = np.full((5,), 47.3, np.float32)
    want = np.asarray(jsm.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels)))
    got = tsm.apply(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_state_dict_prefix_and_sigmas():
    _, tcfg = _cfgs("positional")
    sd = {"module.pre_dense.weight": torch.ones(128, 51)}
    assert list(strip_module_prefix(sd)) == ["pre_dense.weight"]
    params = params_from_torch_state_dict(sd, tcfg, device=CPU)
    assert params["pre_dense"]["weight"].shape == (128, 51)
    assert params["sigmas"].shape == (tcfg.num_scales,)
