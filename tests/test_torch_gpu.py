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
@pytest.mark.parametrize("hidden,rows", [(1024, (4096, 1001)), (384, (2048,)),
                                         (768, (2048,)), (2048, (2048, 77))])
def test_cuda_kernel_matches_plain_version(cuda_device, hidden, rows, gn):
    """The CUDA kernel against its plain version in both GroupNorm modes: at
    the published width (groups of 32, the shuffle reduction) and at widths
    whose groups of 12, 24 and 64 reduce through shared memory, on
    tile-aligned and ragged row counts."""
    packed, vecs = _packed(cuda_device, hidden, gn)
    gen = torch.Generator().manual_seed(1)
    for n in rows:
        x = torch.randn(n, 51, generator=gen).to(cuda_device)
        before = tsk.launch_counts["fused_score_forward"]
        got = tsk.fused_score_forward(x, packed, vecs)
        torch.cuda.synchronize()
        assert tsk.launch_counts["fused_score_forward"] == before + 1
        want = tsk.fused_score_forward_reference(x, packed, vecs)
        assert (got - want).abs().max().item() < TOL


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
