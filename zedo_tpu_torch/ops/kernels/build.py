"""Build and load the port's CUDA kernels.

Each source in `zedo_tpu_torch/csrc/` is compiled with `nvcc` for sm_90a
into a shared library with a plain C interface, at first use, under
`build/zedo_tpu_torch/<source hash>/` beside the package, and loaded with
ctypes. `build()` starts one nvcc for each library that is not built yet,
all together, and waits for them. Without CUDA or nvcc it raises: there is
no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "zedo_tpu_torch"
# library name -> its source in csrc/
SOURCES = {"score_mlp": "score_mlp.cu", "score_mlp_split": "score_mlp_split.cu"}


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when the library was already built
    ptxas: str  # nvcc -Xptxas -v resource lines of this build


_loaded: dict = {}  # library name -> Library, once per process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit "
                       "at first use (set CUDA_HOME)")


def _so_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / f"libzedo_{name}.so"


def build(names=tuple(SOURCES)) -> dict:
    """{name: Library} for `names`, building the missing ones in parallel."""
    if not torch.cuda.is_available():
        raise RuntimeError("the zedo_tpu_torch kernels need a CUDA device")
    todo = [n for n in names if n not in _loaded]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        so = _so_path(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.so")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, so)
    built = {}
    for name, (proc, tmp, so) in procs.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} ({proc.returncode}):\n{stderr}")
        os.replace(tmp, so)
        built[name] = "\n".join(line for line in stderr.splitlines()
                                if "registers" in line or "spill" in line)
    seconds = time.perf_counter() - t0
    for name in todo:
        so = _so_path(name)
        _loaded[name] = Library(ctypes.CDLL(str(so)), str(so),
                                seconds if name in built else 0.0, built.get(name, ""))
    return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if need be."""
    return build((name,))[name].lib
