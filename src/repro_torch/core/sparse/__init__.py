from .formats import CSR, HybridELL, TileELL, hybrid_width_cap
from . import random

__all__ = ["CSR", "HybridELL", "TileELL", "hybrid_width_cap", "random"]
