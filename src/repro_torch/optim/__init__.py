"""The optimizer of the port's LM training (twin of ``repro.optim``)."""
from . import adamw
from .adamw import OptConfig

__all__ = ["OptConfig", "adamw"]
