"""zedo_tpu_torch split score kernel: its plain version against the JAX
`_kernel_split` of tools/bench_kernel.py (parsed out of the tool, run in
Pallas interpret mode on the CPU) and against the fused Pallas kernel. The
CUDA kernel itself is held against the plain version in
tests/test_torch_gpu.py."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.ops.pallas import score_kernel as jsk
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.ops.kernels import score_kernel_split as tsplit
from zedo_tpu_torch.utils.checkpoint import params_from_numpy

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tools", "bench_kernel.py")
GN_DTYPES = {"bf16": (None, None), "f32": (jnp.float32, torch.float32)}


def _kernel_split():
    """`_kernel_split` as the tool defines it (inside main, under --split),
    executed with the names it reads from the tool's scope."""
    tree = ast.parse(open(TOOL).read())
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_kernel_split")
    scope = {"jnp": jnp, "sk": jsk}
    exec(compile(ast.Module(body=[node], type_ignores=[]), TOOL, "exec"), scope)
    return scope["_kernel_split"]


def _fwd_split(x_pad, packed, vecs, tile):
    """The tool's `fwd_split` pallas_call (same BlockSpecs), in interpret mode."""
    b_pad, iop = x_pad.shape
    h = packed.w_pre.shape[1]

    def full(shape):
        return pl.BlockSpec(shape, lambda i: tuple(0 for _ in shape),
                            memory_space=pltpu.VMEM)

    return pl.pallas_call(
        _kernel_split(), grid=(b_pad // tile,),
        in_specs=[pl.BlockSpec((tile, iop), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  full((iop, h)), full((h, h)), full((h, h)), full((h, h)), full((h, h)),
                  full((h, iop)), full((5, h)), full((5, h)), full((iop,)),
                  full((h, jsk.LANE)), full((5, jsk.LANE, h))],
        out_specs=pl.BlockSpec((tile, iop), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b_pad, iop), jnp.float32),
        interpret=True,
    )(x_pad, packed.w_pre, *packed.w_b, packed.w_post, vecs, packed.gn_bias,
      packed.bias_post, packed.ind, packed.bcast_scaled)


def _setup(hidden, embed, gn, seed=0):
    jcfg = jsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed)
    tcfg = tsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                           jsm.init_params(jax.random.PRNGKey(seed), jcfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jgn, tgn = GN_DTYPES[gn]
    jpacked = jsk.pack_weights(jparams, jcfg, gn_dtype=jgn)
    tpacked = tsk.pack_weights(tparams, tcfg, gn_dtype=tgn)
    jvecs = jsk.step_vectors(
        jpacked, jsm.time_embedding(jparams, jcfg, jnp.full((1,), 47.3, jnp.float32))[0])
    tvecs = tsk.step_vectors(tpacked, tsm.time_embedding(tparams, tcfg, torch.full((1,), 47.3))[0])
    return jpacked, jvecs, tpacked, tvecs


def _median_rel(got, want):
    # the same products on the same bf16 operands; only the f32 summation
    # order differs, which can flip a bf16 rounding between layers
    return np.median(np.abs(got - want) / (np.abs(want) + 1e-2))


@pytest.mark.parametrize("gn", ["bf16", "f32"])
@pytest.mark.parametrize("hidden,embed", [(256, 128), (1024, 512)])
def test_split_plain_version_matches_jax_split_and_fused(hidden, embed, gn):
    rows = 128
    jpacked, jvecs, tpacked, tvecs = _setup(hidden, embed, gn)
    x = np.random.RandomState(4).randn(rows, 51).astype(np.float32)
    x_pad = jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - 51)))
    want_split = np.asarray(_fwd_split(x_pad, jpacked, jvecs, tile=rows))[:, :51]
    want_fused = np.asarray(jsk.fused_score_forward(x_pad, jpacked, jvecs, tile=rows,
                                                    interpret=True))[:, :51]
    got = tsplit.fused_score_forward_split(torch.from_numpy(x), tpacked, tvecs).numpy()
    assert got.shape == (rows, 51) and np.isfinite(got).all()
    assert _median_rel(got, want_split) < 0.02
    assert _median_rel(got, want_fused) < 0.02
    # the split reference is the fused reference's function, whatever the tile
    fused = tsk.fused_score_forward_reference(torch.from_numpy(x), tpacked, tvecs).numpy()
    for tile in (tsplit.TILE_ROWS, rows):
        split = tsplit.fused_score_forward_split_reference(torch.from_numpy(x), tpacked,
                                                           tvecs, tile=tile).numpy()
        assert _median_rel(split, fused) < 1e-3


def test_split_plain_version_ragged_rows_and_launch_count():
    """A row count that is no multiple of the tile; on the CPU the wrapper
    takes the plain version and launches nothing."""
    _, _, tpacked, tvecs = _setup(256, 128, "bf16")
    x = torch.from_numpy(np.random.RandomState(5).randn(45, 51).astype(np.float32))
    before = tsplit.launch_counts["fused_score_forward_split"]
    got = tsplit.fused_score_forward_split(x, tpacked, tvecs)
    assert tsplit.launch_counts["fused_score_forward_split"] == before
    want = tsk.fused_score_forward_reference(x, tpacked, tvecs)
    assert got.shape == (45, 51)
    assert _median_rel(got.numpy(), want.numpy()) < 1e-3
    with pytest.raises(ValueError, match="unsupported device"):
        tsplit.fused_score_forward_split(torch.zeros(4, 51, device="meta"), tpacked, tvecs)
