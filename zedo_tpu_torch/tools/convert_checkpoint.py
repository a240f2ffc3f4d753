"""Cluster-file conversion CLI.

    python -m zedo_tpu_torch.tools.convert_checkpoint cluster h36m_cluster50.pkl h36m_cluster50.npy

Port of tools/convert_checkpoint.py. cluster: README-shipped .pkl cluster
files -> the .npy the loaders expect. The tool's pth2native and native2pth
modes write and read orbax checkpoints, the JAX package's own format; the
port reads the reference's .pth checkpoints directly
(utils.checkpoint.load_torch_checkpoint), so those modes raise here.
"""
from __future__ import annotations

import sys

import numpy as np

from zedo_tpu_torch.utils.checkpoint import convert_cluster_file


def cluster(src: str, dst: str) -> np.ndarray:
    arr = np.asarray(convert_cluster_file(src))
    np.save(dst, arr)
    print(f"wrote {arr.shape} clusters to {dst}")
    return arr


def _orbax(mode: str):
    def run(src: str, dst: str):
        raise NotImplementedError(
            f"{mode} converts to or from orbax, the JAX package's checkpoint format; "
            "the port loads .pth checkpoints as they are (utils.checkpoint."
            "load_torch_checkpoint): use `python tools/convert_checkpoint.py` for orbax")
    return run


MODES = {"cluster": cluster, "pth2native": _orbax("pth2native"),
         "native2pth": _orbax("native2pth")}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3 or argv[0] not in MODES:
        print(__doc__)
        raise SystemExit(1)
    mode, src, dst = argv[:3]
    return MODES[mode](src, dst)


if __name__ == "__main__":
    main()
