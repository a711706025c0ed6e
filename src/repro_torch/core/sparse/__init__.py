from .formats import (CSR, HybridELL, TileELL, block_csr_pattern,
                      hybrid_width_cap)
from . import random

__all__ = ["CSR", "HybridELL", "TileELL", "block_csr_pattern",
           "hybrid_width_cap", "random"]
