"""Step-tagged checkpoints in the reference's layout (twin of
``repro.checkpoint``)."""
from .ckpt import latest_step, prune, restore, save

__all__ = ["save", "restore", "latest_step", "prune"]
