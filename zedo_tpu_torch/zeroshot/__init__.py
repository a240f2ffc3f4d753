"""Zero-shot 2D->3D pose optimization: IPO (init fit) + OIL (diffusion-in-the-loop)."""
from zedo_tpu_torch.zeroshot import ipo, oil, pipeline

__all__ = ["ipo", "oil", "pipeline"]
