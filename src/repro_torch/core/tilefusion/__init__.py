"""Tile fusion — the paper's contribution as a PyTorch module.

``api.tile_fused_matmul`` is the one fused-matmul entrypoint (inspector
cache + backend dispatch); the submodules below are its building blocks.
"""
from .scheduler import Schedule, Tile, build_schedule
from .schedule import DeviceSchedule, to_device_schedule
from . import api, fused_ops, fused_ref, hetero, reorder, serving
from .api import (clear_schedule_cache, get_schedule, schedule_cache_stats,
                  select_backend, tile_fused_matmul)
from .hetero import HeteroStack, hetero_fused_matmul, stack_adjacencies
from .serving import ServingTier
from .spec import FusionSpec

__all__ = [
    "Schedule", "Tile", "build_schedule", "DeviceSchedule",
    "to_device_schedule", "api", "fused_ops", "fused_ref", "reorder",
    "HeteroStack", "hetero", "hetero_fused_matmul", "stack_adjacencies",
    "ServingTier", "serving",
    "tile_fused_matmul", "get_schedule", "select_backend",
    "clear_schedule_cache", "schedule_cache_stats", "FusionSpec",
]
