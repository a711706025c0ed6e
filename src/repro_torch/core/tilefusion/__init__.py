"""Tile fusion — the paper's contribution as a PyTorch module.

``api.tile_fused_matmul`` is the one fused-matmul entrypoint (inspector
cache + backend dispatch); the submodules below are its building blocks.
The exports are the reference's, without its TPU VMEM budget.
"""
from .cost_model import (DEFAULT_CPU_CACHE_BYTES, tile_cost_bytes,
                         tile_cost_elements, tile_costs_batch)
from .scheduler import (Schedule, Tile, balanced_contiguous_partition,
                        build_schedule, fused_compute_ratio)
from .schedule import DeviceSchedule, to_device_schedule
from .sharded import ShardedSchedule, build_sharded_schedule, mesh_key
from . import api, fused_ops, fused_ref, hetero, reorder, serving, sharded
from .api import (clear_schedule_cache, get_schedule, schedule_cache_stats,
                  select_backend, tile_fused_matmul)
from .hetero import HeteroStack, hetero_fused_matmul, stack_adjacencies
from .serving import ServingTier
from .spec import FusionSpec

__all__ = [
    "Schedule", "Tile", "build_schedule", "fused_compute_ratio",
    "balanced_contiguous_partition",
    "DeviceSchedule", "to_device_schedule", "api", "fused_ops", "fused_ref",
    "reorder", "ShardedSchedule", "build_sharded_schedule", "mesh_key",
    "sharded", "ServingTier", "serving",
    "HeteroStack", "hetero", "hetero_fused_matmul", "stack_adjacencies",
    "tile_fused_matmul", "get_schedule", "select_backend",
    "clear_schedule_cache", "schedule_cache_stats", "FusionSpec",
    "tile_cost_bytes", "tile_cost_elements", "tile_costs_batch",
    "DEFAULT_CPU_CACHE_BYTES",
]
