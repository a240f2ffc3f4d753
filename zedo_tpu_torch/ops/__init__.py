"""Pose geometry in torch (rotation math, cameras, Procrustes, metrics,
ray-gradient field). The CUDA kernels are in ops/kernels, built when first
launched."""
from zedo_tpu_torch.ops import camera, gradient_field, linalg, metrics, procrustes, rotations

__all__ = ["camera", "gradient_field", "linalg", "metrics", "procrustes", "rotations"]
