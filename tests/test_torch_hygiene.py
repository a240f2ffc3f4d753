"""zedo_tpu_torch stands alone: no jax, no zedo_tpu, no ml_collections, no absl,
no configs, and no matplotlib at import time; asks for CUDA by default and
raises without it; no fallback from the kernel."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch.models import control_mlp as tcm
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models import score_mlp_cond as tcond
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.ops.kernels import score_kernel_probe as tprobe
from zedo_tpu_torch.ops.kernels import score_kernel_split as tsplit
from zedo_tpu_torch.run import opt_main_infant
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.zeroshot import oil as toil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import zedo_tpu_torch
for m in pkgutil.walk_packages(zedo_tpu_torch.__path__, "zedo_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "zedo_tpu", "ml_collections", "absl", "configs",
                                    "matplotlib"))
print("MODULES", len([m for m in sys.modules if m.startswith("zedo_tpu_torch")]))
print("BAD", bad)
print(sorted(m for m in sys.modules if m.startswith("zedo_tpu_torch")))
"""


def test_port_imports_no_jax_no_reference_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 20
    # the infant path's and the training path's modules are among them
    for name in ("diffusion.score", "models.control_mlp", "models.score_mlp_cond",
                 "zeroshot.infant", "data.mini_rgbd", "data.syrip", "run.opt_main_infant",
                 "diffusion.losses", "diffusion.ema", "diffusion.ode", "diffusion.guidance",
                 "train.trainer", "run.train_pose_mini", "run.sample", "tools.bench_train",
                 "data.concat", "models.registry", "tools.bench_serving", "tools.make_clusters",
                 "tools.make_trained_fixture", "examples.quickstart", "utils.visualize",
                 "ops.kernels.score_kernel_probe"):
        assert f"zedo_tpu_torch.{name}" in out.stdout, name


def test_library_layers_import_no_cli():
    """Below the entry points (run/, tools/, examples/) no module imports a
    CLI, at import time or inside a function."""
    root = os.path.join(REPO, "zedo_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root).split(os.sep)[0]
        if rel in ("run", "tools", "examples"):
            continue
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                if any(n == "zedo_tpu_torch.run" or n.startswith("zedo_tpu_torch.run.")
                       for n in names):
                    offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


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
    for module in (tcm, tcond):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.init_params(torch.Generator().manual_seed(0),
                               tsm.ScoreMLPConfig(hidden_dim=128))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opt_main_infant.main(["--config", "mini"])


def test_kernel_wrapper_never_falls_back():
    _no_cuda()
    for module in (tsk, tsplit, tprobe):
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
    # the infant path's 12 joints (36 columns) take the same wrapper
    cfg12 = tsm.ScoreMLPConfig(n_joints=12, hidden_dim=128, embed_dim=64)
    params12 = tsm.init_params(torch.Generator().manual_seed(0), cfg12, device="cpu")
    packed12 = tsk.pack_weights(params12, cfg12, gn_dtype=torch.float32)
    vecs12 = tsk.step_vectors(packed12, torch.zeros(64))
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.fused_score_forward(torch.zeros(4, 36, device="meta"), packed12, vecs12)
    bf16_12 = tree_map(lambda a: a.to(torch.bfloat16), params12)
    assert toil.model_path(bf16_12, cfg12, toil.OILConfig()) == "plain"
    # on the CPU the kernel path is never chosen automatically
    bf16 = tree_map(lambda a: a.to(torch.bfloat16), params)
    assert toil.model_path(bf16, cfg, toil.OILConfig()) == "plain"
    before = tsk.launch_counts["fused_score_forward"], dict(tsk.row_launches)
    out = tsk.fused_score_forward(torch.zeros(4, 51), packed, vecs)
    assert out.shape == (4, 51) and np.isfinite(out.numpy()).all()
    assert (tsk.launch_counts["fused_score_forward"], tsk.row_launches) == before
