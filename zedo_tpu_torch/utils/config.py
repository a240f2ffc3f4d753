"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without it raises: nothing carries on quietly on the
CPU. On the card, float32 products run in full float32 (DESIGN.md "Numerics
policy": geometry is always full precision, the counterpart of
`Precision.HIGHEST` in the JAX package), so TF32 is switched off for both
matrix products and convolutions.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
