"""Build and load the port's CUDA kernels.

Each `.cu` source in `zedo_tpu_torch/csrc/` is compiled with `nvcc` for
sm_90a into a shared library with a plain C interface, at first use, under
`build/zedo_tpu_torch/<hash of csrc/>/` beside the package, and loaded with
ctypes. The headers the sources share (`hopper.cuh`, `score_mlp.cuh`) are part
of the hash.
`build()` starts one nvcc for each library that is not built yet, all
together, and waits for them. Without CUDA or nvcc it raises: there is no
fallback.
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
SOURCES = {"score_mlp": "score_mlp.cu", "score_mlp_split": "score_mlp_split.cu",
           "score_mlp_probe": "score_mlp_probe.cu", "score_mlp_control": "score_mlp_control.cu",
           "ipo_step": "ipo_step.cu"}


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when the library was already built
    ptxas: str  # nvcc -Xptxas -v lines of this build: entry names, registers, spills


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
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"libzedo_{name}.so"


def nvcc_command(source, out) -> list:
    """The nvcc call that compiles one source (of csrc/, or a copy of one
    elsewhere: csrc/ is on the include path) into the shared library `out`."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out),
            str(source), "-ldl"]


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
        procs[name] = (subprocess.Popen(nvcc_command(CSRC / SOURCES[name], tmp),
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, so)
    built = {}
    for name, (proc, tmp, so) in procs.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} ({proc.returncode}):\n{stderr}")
        os.replace(tmp, so)
        built[name] = "\n".join(line for line in stderr.splitlines()
                                if "Compiling entry" in line or "registers" in line
                                or "spill" in line)
    seconds = time.perf_counter() - t0
    for name in todo:
        so = _so_path(name)
        _loaded[name] = Library(ctypes.CDLL(str(so)), str(so),
                                seconds if name in built else 0.0, built.get(name, ""))
    return {n: _loaded[n] for n in names}


def resources(ptxas: str) -> dict:
    """{demangling-free kernel name: (registers, spill bytes)} from the
    `ptxas` lines of a Library."""
    out, name, spill = {}, None, 0
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif "spill" in line:
            words = line.replace(",", " ").split()
            spill = sum(int(words[i - 2]) for i, w in enumerate(words) if w == "spill")
        elif "registers" in line and name is not None:
            words = line.replace(",", " ").split()
            out[name] = (int(words[words.index("registers") - 1]), spill)
    return out


def sass(path) -> str:
    """The SASS of a built library (cuobjdump of the CUDA toolkit)."""
    dump = subprocess.run([os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass",
                           str(path)], capture_output=True, text=True, timeout=300)
    if dump.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {path}:\n{dump.stderr[-2000:]}")
    return dump.stdout


def count_sass_instructions(dump: str) -> dict:
    """{kernel name: instructions} of a `cuobjdump -sass` listing. A kernel
    whose hot loop outgrows the instruction cache pays for it on every
    pass."""
    out, name = {}, None
    for line in dump.splitlines():
        words = line.split()
        if len(words) >= 3 and words[0] == "Function" and words[1] == ":":
            name = words[2]
            out[name] = 0
        elif (name is not None and len(words) > 1 and words[0].startswith("/*")
              and words[0].endswith("*/") and len(words[0]) > 4
              and not words[1].startswith("/*")):
            out[name] += 1
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if need be."""
    return build((name,))[name].lib
