"""Two-process evidence runners (port of
zedo_tpu/parallel/multiprocess_check.py).

`run_ranks` launches one Python process per rank with torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), so a child joins
with `parallel.mesh.init_distributed()`; each run has a timeout of its own,
and when a rank fails or the time is up every rank still running is killed
(a survivor would wait in a collective for its dead peer). The child scripts
run two Gloo processes on the CPU:

  * CHILD_TRAIN: the sharded train step on a dp2 mesh, with its gradient
    all-reduce; both replicas must stay bit-identical;
  * CHILD_SOLVE: the sharded solve (pipeline.solve_sharded); both processes
    must hold one identical global result that matches a one-process solve
    of the same scene.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["CHILD_TRAIN", "CHILD_SOLVE", "free_port", "run_ranks", "run_two_process",
           "two_process_evidence"]


def free_port() -> int:
    """An ephemeral port for the rendezvous (a fixed one flakes when two runs
    share a machine)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(argv: list, world_size: int = 2, timeout: float = 120, cwd=None,
              env: dict | None = None) -> list[str]:
    """Run `python *argv` once per rank with torchrun's environment; returns
    each rank's standard output. Raises if a rank fails or the runs outlast
    `timeout` seconds, with the ranks' standard error."""
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_repo_root(), base.get("PYTHONPATH", "")) if p)
    base.update(WORLD_SIZE=str(world_size), MASTER_ADDR="localhost",
                MASTER_PORT=str(free_port()))
    with tempfile.TemporaryDirectory() as logs:
        files, procs = [], []
        try:
            for rank in range(world_size):
                out = open(os.path.join(logs, f"{rank}.out"), "w+")
                err = open(os.path.join(logs, f"{rank}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], stdout=out, stderr=err,
                    cwd=cwd or _repo_root(),
                    env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank))))
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        late = "" if time.monotonic() < deadline else f" (killed after {timeout} s)"
        detail = "\n".join(f"--- rank {r} (exit {c}) ---\n{o[-3000:]}\n{e[-6000:]}"
                           for r, (c, (o, e)) in enumerate(zip(codes, texts)))
        raise RuntimeError(f"rank processes failed{late}:\n{detail}")
    return [o for o, _ in texts]


def run_two_process(child_src: str, cwd=None, timeout: float = 120) -> list[str]:
    """`child_src` as two Gloo ranks on the CPU; returns each rank's RESULT
    line."""
    outs = run_ranks(["-c", child_src], 2, timeout, cwd, env={"OMP_NUM_THREADS": "2"})
    lines = []
    for out in outs:
        found = [line for line in out.splitlines() if line.startswith("RESULT")]
        if len(found) != 1:
            raise RuntimeError(f"expected one RESULT line, got:\n{out}")
        lines.append(found[0])
    return lines


CHILD_TRAIN = r"""
import torch
import torch.distributed as dist
from zedo_tpu_torch.parallel import mesh as mesh_lib
mesh_lib.init_distributed(device="cpu")
from zedo_tpu_torch.diffusion import losses as losses_lib
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.presets import Config
from zedo_tpu_torch.train import trainer

mesh = mesh_lib.default_mesh(device="cpu")  # spans both processes
assert mesh.size == 2, mesh
cfg = score_mlp.ScoreMLPConfig(n_joints=17, joint_dim=3, hidden_dim=64, embed_dim=32,
                               n_blocks=1, embedding_type="positional")
params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
conf = Config(optim=Config(optimizer="Adam", lr=2e-4, beta1=0.9, eps=1e-8, warmup=0,
                           grad_clip=1.0, weight_decay=0))
optimizer = losses_lib.get_optimizer(conf)
state = losses_lib.init_train_state(params, optimizer, ema_decay=0.9999)
sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=1.0)
step, rows = trainer.make_sharded_train_step(mesh, sde, score_mlp.apply, cfg, optimizer)
gbatch = torch.linspace(0, 1, 16 * 17 * 3).reshape(16, 17, 3)
state, loss = step(state, torch.Generator().manual_seed(7), gbatch[rows(16)])
wsum = state.params["pre_dense"]["weight"].sum().item()
print(f"RESULT loss={loss.item()!r} wsum={wsum!r} step={state.step}")
dist.destroy_process_group()
"""


CHILD_SOLVE = r"""
import numpy as np
import torch
import torch.distributed as dist
from zedo_tpu_torch.parallel import mesh as mesh_lib
mesh_lib.init_distributed(device="cpu")
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops import camera
from zedo_tpu_torch.zeroshot import ipo as ipo_lib
from zedo_tpu_torch.zeroshot import oil as oil_lib
from zedo_tpu_torch.zeroshot import pipeline

mesh = mesh_lib.default_mesh(device="cpu")
assert mesh.size == 2, mesh
cfg = score_mlp.ScoreMLPConfig(n_joints=17, joint_dim=3, hidden_dim=64, embed_dim=32,
                               n_blocks=1, embedding_type="positional")
params = score_mlp.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                    probability_flow=True, denoise=True, eps=0.01)
zcfg = pipeline.ZeDOConfig(ipo=ipo_lib.IPOConfig(iterations=5),
                           oil=oil_lib.OILConfig(iterations=5))

# a deterministic synthetic scene, the same in both processes
rng = np.random.RandomState(7)
n = 16
pose = rng.randn(n, 17, 3).astype(np.float32) * 0.25
pose -= pose[:, 0:1]
t = np.zeros((n, 1, 3), np.float32); t[..., 2] = 4.0
k = np.zeros((n, 3, 3), np.float32)
k[:, 0, 0] = k[:, 1, 1] = 1000.0
k[:, 0, 2] = k[:, 1, 2] = 500.0
k[:, 2, 2] = 1.0
px = camera.project(torch.from_numpy(pose + t), torch.from_numpy(k))
clusters = torch.from_numpy(pose[:1])
k = torch.from_numpy(k)

with torch.no_grad():
    full = pipeline.solve_sharded(mesh, params, cfg, sde, sampler, zcfg, clusters, px,
                                  None, k).poses
    local = pipeline.solve(params, cfg, sde, sampler, zcfg, clusters, px, None, k).poses
maxdiff = (full - local).abs().max().item()
print(f"RESULT shape={tuple(full.shape)} sum={full.sum().item()!r} "
      f"maxdiff_vs_single={maxdiff:.2e} ok={maxdiff < 1e-5}")
dist.destroy_process_group()
"""


def two_process_evidence(timeout: float = 120) -> list[str]:
    """Run both two-process checks; summary lines (raises on a failure)."""
    train = run_two_process(CHILD_TRAIN, timeout=timeout)
    if train[0] != train[1] or "step=1" not in train[0]:
        raise AssertionError(f"train replicas differ: {train}")
    solve = run_two_process(CHILD_SOLVE, timeout=timeout)
    if solve[0] != solve[1] or "ok=True" not in solve[0]:
        raise AssertionError(f"sharded solve: {solve}")
    return [
        f"2-process train (Gloo all-reduce): replicas bit-identical [{train[0]}]",
        "2-process sharded eval solve: global result identical on both processes and "
        f"matches the 1-process solve [{solve[0]}]",
    ]
