"""Score-based diffusion core: SDEs, score wrappers, samplers, losses, EMA."""
from zedo_tpu_torch.diffusion import ema, losses, ode, sampling, score, sde

__all__ = ["ema", "losses", "ode", "sampling", "score", "sde"]
