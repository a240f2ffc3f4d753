"""Tests of the zedo_tpu_torch CUDA kernels; they need the card and skip
without one. This file imports no jax, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version(cuda_device):
    """The CUDA kernel against its plain version at the published width, on
    a tile-aligned and a ragged row count, with f32 GroupNorm statistics."""
    tcfg = tsm.ScoreMLPConfig()
    params = tsm.init_params(torch.Generator().manual_seed(0), tcfg, device=cuda_device)
    packed = tsk.pack_weights(params, tcfg, dtype=torch.bfloat16, gn_dtype=torch.float32)
    temb = tsm.time_embedding(params, tcfg, torch.full((1,), 47.3, device=cuda_device))[0]
    vecs = tsk.step_vectors(packed, temb).contiguous()
    gen = torch.Generator().manual_seed(1)
    for rows in (4096, 1001):
        x = torch.randn(rows, 51, generator=gen).to(cuda_device)
        before = tsk.launch_counts["fused_score_forward"]
        got = tsk.fused_score_forward(x, packed, vecs)
        torch.cuda.synchronize()
        assert tsk.launch_counts["fused_score_forward"] == before + 1
        want = tsk.fused_score_forward_reference(x, packed, vecs)
        # same bf16 operands; the f32 sums run in another order
        assert (got - want).abs().max().item() < 2e-2
