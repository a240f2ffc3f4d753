"""zedo_tpu_torch stands alone: no jax, no zedo_tpu, no ml_collections; asks
for CUDA by default and raises without it; no fallback from the kernel."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.ops.kernels import score_kernel_split as tsplit
from zedo_tpu_torch.serving import ZeDOEstimator, _tree_map
from zedo_tpu_torch.zeroshot import oil as toil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import zedo_tpu_torch
for m in pkgutil.walk_packages(zedo_tpu_torch.__path__, "zedo_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "zedo_tpu."))
             or m == "zedo_tpu" or m == "ml_collections")
print("MODULES", len([m for m in sys.modules if m.startswith("zedo_tpu_torch")]))
print("BAD", bad)
"""


def test_port_imports_no_jax_no_reference_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 20


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS,
                                            preset=presets.h36m(hidden_dim=256, embed_dim=128))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsm.init_params(torch.Generator().manual_seed(0), tsm.ScoreMLPConfig(hidden_dim=128))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbt.load_fixture()


def test_kernel_wrapper_never_falls_back():
    _no_cuda()
    for module in (tsk, tsplit):
        with pytest.raises(RuntimeError, match="CUDA device"):
            module.load_library()
    cfg = tsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64)
    params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    packed = tsk.pack_weights(params, cfg, gn_dtype=torch.float32)
    vecs = tsk.step_vectors(packed, torch.zeros(64))
    # a tensor that is not on the CPU never reaches the plain version
    for wrapper in (tsk.fused_score_forward, tsplit.fused_score_forward_split):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(torch.zeros(4, 51, device="meta"), packed, vecs)
    # on the CPU the kernel path is never chosen automatically
    bf16 = _tree_map(lambda a: a.to(torch.bfloat16), params)
    assert not toil._kernel_eligible(bf16, cfg)
    before = tsk.launch_counts["fused_score_forward"]
    out = tsk.fused_score_forward(torch.zeros(4, 51), packed, vecs)
    assert out.shape == (4, 51) and np.isfinite(out.numpy()).all()
    assert tsk.launch_counts["fused_score_forward"] == before
