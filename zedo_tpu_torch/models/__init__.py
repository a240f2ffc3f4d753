"""Score-network model zoo."""
from zedo_tpu_torch.models import nn, score_mlp

__all__ = ["nn", "score_mlp"]
