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
    for tile in (tsplit.tile_rows(hidden), rows):
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


@pytest.mark.parametrize("hidden,embed,gn", [(256, 128, "bf16"), (1024, 512, "bf16"),
                                             (1024, 512, "f32")])
def test_split_plain_version_at_kernel_tile_and_ragged_rows(hidden, embed, gn):
    """The plain version at the row tile the kernel takes (56 rows) on row
    counts that leave a ragged tile (1, R - 1, R + 1, and 2R + 1: three
    tiles), against the JAX `_kernel_split` at that
    tile in interpret mode and the fused Pallas kernel. Same tolerance as
    above: the same products on the same bf16 operands, f32 sums in another
    order."""
    tile = tsplit.tile_rows(hidden)
    assert tile == 56
    jpacked, jvecs, tpacked, tvecs = _setup(hidden, embed, gn)
    x = np.zeros((3 * tile, 51), np.float32)
    x[:2 * tile + 1] = np.random.RandomState(6).randn(2 * tile + 1, 51)
    x_pad = jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - 51)))
    want_split = np.asarray(_fwd_split(x_pad, jpacked, jvecs, tile=tile))[:, :51]
    want_fused = np.asarray(jsk.fused_score_forward(x_pad, jpacked, jvecs, tile=tile,
                                                    interpret=True))[:, :51]
    full = tsplit.fused_score_forward_split_reference(torch.from_numpy(x), tpacked,
                                                      tvecs).numpy()
    for rows in (1, tile - 1, tile + 1, 2 * tile + 1):
        assert 0 <= tsplit.grid_blocks(rows, tile) * tile - rows < tile
        got = tsplit.fused_score_forward_split(torch.from_numpy(x[:rows]), tpacked, tvecs).numpy()
        assert got.shape == (rows, 51) and np.isfinite(got).all()
        assert _median_rel(got, want_split[:rows]) < 0.02, rows
        assert _median_rel(got, want_fused[:rows]) < 0.02, rows
        # rows do not see each other: a ragged tile gives the full tile's rows
        assert np.abs(got - full[:rows]).max() < 1e-5, rows


@pytest.mark.parametrize("hidden,stages", [(128, 16), (256, 16), (512, 16), (768, 16),
                                           (1024, 13)])
def test_tile_rows_rule_fixed_values(hidden, stages):
    """The Python mirror of the library's rule, held to fixed values: 56 rows
    a block at every hidden width up to 1024 (a layer's output waits in
    registers, 8 channel tiles of 64 a warpgroup), and for the weight ring
    what a block's shared memory has left beside the bf16 activation buffer
    (2 * hidden bytes a row), at most 16 tiles of 8 KB."""
    assert tsplit.tile_rows(hidden) == 56
    assert tsplit.check_width(hidden, 32) == 56
    assert tsplit.ring_stages(hidden) == stages
    assert tsplit.smem_bytes(hidden, stages) <= tsplit.SMEM_LIMIT
    if stages < tsplit.MAX_STAGES:
        assert tsplit.smem_bytes(hidden, stages + 1) > tsplit.SMEM_LIMIT


@pytest.mark.parametrize("hidden,group,why", [(2048, 64, "hidden 2048"), (1152, 32, "hidden 1152"),
                                              (1024, 128, "groups of 128"),
                                              (768, 24, "groups of 24"), (1024, 2, "groups of 2"),
                                              (192, 8, "hidden 192")])
def test_widths_the_split_kernel_does_not_take_raise(hidden, group, why):
    """Widths above 1024 (a layer's output would not fit the registers that
    hold it), widths that are no multiple of 128 and GroupNorm groups the
    register epilogue does not reduce raise, naming the width and the rule."""
    assert tsplit.tile_rows(2048) == 0 and tsplit.tile_rows(1088) == 0
    with pytest.raises(ValueError, match=why):
        tsplit.check_width(hidden, group)


def test_grid_blocks_are_the_row_tiles():
    assert tsplit.grid_blocks(44300, 56) == 792  # six blocks for each of 132 SMs
    assert tsplit.grid_blocks(1, 56) == 1
    assert tsplit.grid_blocks(56, 56) == 1
    assert tsplit.grid_blocks(113, 56) == 3  # a ragged last tile


@pytest.mark.parametrize("rows", [8, 24, 56, 64])
def test_swizzle128_mirror_is_a_chunk_preserving_permutation(rows):
    """The pure-Python mirror of the kernel's address function against the
    definition of the 128-byte swizzle: within each 1024-byte atom (8 rows of
    128 bytes) the 16-byte chunk index is XORed with the row's index in the
    atom. So it permutes each atom and keeps 16-byte chunks whole."""
    size = rows * 128
    image = [tsplit.swizzle128(o) for o in range(size)]
    for o, got in enumerate(image):
        row, chunk, byte = o // 128, (o % 128) // 16, o % 16
        assert got == row * 128 + ((chunk ^ (row % 8)) * 16) + byte
    for atom in range(0, size, 1024):
        assert sorted(image[atom:atom + 1024]) == list(range(atom, atom + 1024))
    # an involution: applying it twice gives the offset back
    assert [tsplit.swizzle128(o) for o in image] == list(range(size))
