"""Device selection, dtype resolution and config overrides for the port's
entry points (port of the torch-relevant half of zedo_tpu/utils/config.py;
its compilation cache, `is_tpu_like` and `resolve_prng` are JAX matters).

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without it raises: nothing carries on quietly on the
CPU. On the card, float32 products run in full float32 (DESIGN.md "Numerics
policy": geometry is always full precision, the counterpart of
`Precision.HIGHEST` in the JAX package), so TF32 is switched off for both
matrix products and convolutions.
"""
from __future__ import annotations

import ast

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


def resolve_dtype(choice: str, device: torch.device) -> str:
    """CLI --dtype resolution: 'auto' is bf16 on CUDA, the path of the
    hand-written score kernel (the counterpart of JAX's bf16 on TPU-class
    backends), and fp32 elsewhere; 'fp32' and 'bf16' stay as given."""
    if choice != "auto":
        return choice
    return "bf16" if torch.device(device).type == "cuda" else "fp32"


def cli_int_arg(argv: list[str], name: str, default: int) -> int:
    """Tiny positional `--flag value` int parser for the bench tools."""
    if name in argv:
        try:
            return int(argv[argv.index(name) + 1])
        except (IndexError, ValueError):
            raise SystemExit(f"{name} requires an integer value")
    return default


def apply_overrides(config, overrides: list[str]):
    """Apply 'dotted.path=value' strings to a nested config.

    Values parse as Python literals when possible ('0.5', '[1,2]', 'True'),
    else stay strings. Paths must already exist (typo protection)."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key.path=value")
        path, raw = item.split("=", 1)
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = config
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"config has no key {path!r}")
        node[parts[-1]] = value
    return config
