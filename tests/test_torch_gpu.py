"""Tests of the zedo_tpu_torch CUDA kernels; they need the card and skip
without one. This file imports no jax, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.ops.kernels import score_kernel_split as tsplit

# max |kernel - plain|: the same bf16 operands, f32 sums in another order,
# which can flip a bf16 rounding between layers
TOL = 2e-2
GN = {"bf16": None, "f32": torch.float32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _packed(dev, hidden, gn, embed=512):
    tcfg = tsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed)
    params = tsm.init_params(torch.Generator().manual_seed(0), tcfg, device=dev)
    packed = tsk.pack_weights(params, tcfg, dtype=torch.bfloat16, gn_dtype=GN[gn])
    temb = tsm.time_embedding(params, tcfg, torch.full((1,), 47.3, device=dev))[0]
    return packed, tsk.step_vectors(packed, temb).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
@pytest.mark.parametrize("hidden,rows", [(1024, (4096, 1001, 129, 1)), (384, (2048,)),
                                         (768, (2048,)), (2048, (2048, 77)),
                                         (256, (2048, 130)), (128, (300,)), (512, (300,))])
def test_cuda_kernel_matches_plain_version(cuda_device, hidden, rows, gn):
    """The CUDA kernel against its plain version in both GroupNorm modes, on
    tile-aligned and ragged row counts: the wgmma kernel at the published
    width (groups of 32) and at groups of 4, 8, 16 and 64, the wmma kernel at
    the widths whose groups of 12 and 24 reduce through shared memory. Each
    width runs the path `kernel_path` names."""
    packed, vecs = _packed(cuda_device, hidden, gn)
    path = tsk.kernel_path(hidden, packed.group_size)
    gen = torch.Generator().manual_seed(1)
    for n in rows:
        x = torch.randn(n, 51, generator=gen).to(cuda_device)
        before = tsk.launch_counts["fused_score_forward"], tsk.path_launches[path]
        got = tsk.fused_score_forward(x, packed, vecs)
        torch.cuda.synchronize()
        assert tsk.launch_counts["fused_score_forward"] == before[0] + 1
        assert tsk.path_launches[path] == before[1] + 1
        want = tsk.fused_score_forward_reference(x, packed, vecs)
        assert (got - want).abs().max().item() < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
@pytest.mark.parametrize("hidden", [256, 1024, 2048])
def test_forced_wmma_path_matches_plain_version(cuda_device, hidden, gn):
    """The wmma kernel, forced at the widths the wgmma kernel takes, against
    the plain version and the wgmma kernel."""
    packed, vecs = _packed(cuda_device, hidden, gn)
    x = torch.randn(1001, 51, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    before = tsk.path_launches["wmma"]
    got = tsk.fused_score_forward(x, packed, vecs, _force_wmma=True)
    torch.cuda.synchronize()
    assert tsk.path_launches["wmma"] == before + 1
    assert (got - tsk.fused_score_forward_reference(x, packed, vecs)).abs().max().item() < TOL
    assert (got - tsk.fused_score_forward(x, packed, vecs)).abs().max().item() < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (128, 128, 128), (300, 1024, 256), (1, 64, 128)])
def test_wgmma_product_matches_matmul(cuda_device, m, k, n):
    """The wgmma kernel's product alone (TMA boxes, the 128-byte swizzle,
    the K-major A and MN-major B descriptors) against torch.matmul: exact
    bf16 products, f32 sums in another order."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(m, k, generator=gen).to(cuda_device).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen).to(cuda_device).to(torch.bfloat16)
    want = a.float() @ w.float()
    got = tsk.wgmma_product(a, w)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_kernel_path_mirrors_the_library(cuda_device):
    lib = tsk.load_library()
    for hidden in range(128, 2049, 128):
        group = hidden // 32
        tile = tsk.column_tile(hidden, group)
        took = bool(lib.zedo_score_mlp_takes_wgmma(hidden, group, tile))
        assert took == (tsk.kernel_path(hidden, group) == "wgmma"), hidden
    assert lib.zedo_score_mlp_padded_input(51) == tsk.padded_input_columns(51)
    assert lib.zedo_score_mlp_wgmma_blocks_per_sm() == 2


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
def test_split_kernel_matches_plain_version_and_kernel(cuda_device, gn):
    packed, vecs = _packed(cuda_device, 1024, gn)
    gen = torch.Generator().manual_seed(2)
    for n in (4096, 1001, 17):
        x = torch.randn(n, 51, generator=gen).to(cuda_device)
        before = tsplit.launch_counts["fused_score_forward_split"]
        got = tsplit.fused_score_forward_split(x, packed, vecs)
        torch.cuda.synchronize()
        assert tsplit.launch_counts["fused_score_forward_split"] == before + 1
        want = tsplit.fused_score_forward_split_reference(x, packed, vecs)
        assert (got - want).abs().max().item() < TOL
        assert (got - tsk.fused_score_forward(x, packed, vecs)).abs().max().item() < TOL


@pytest.mark.gpu
def test_kernels_raise_on_widths_they_cannot_hold(cuda_device):
    """Groups of 68 channels need a 272-column tile; the split kernel's two
    half tiles do not fit shared memory at hidden 2048. Both raise, naming
    the width."""
    packed, vecs = _packed(cuda_device, 2176, "bf16")
    with pytest.raises(ValueError, match="hidden 2176"):
        tsk.fused_score_forward(torch.zeros(8, 51, device=cuda_device), packed, vecs)
    packed, vecs = _packed(cuda_device, 2048, "bf16")
    with pytest.raises(ValueError, match="hidden 2048"):
        tsplit.fused_score_forward_split(torch.zeros(8, 51, device=cuda_device), packed, vecs)
