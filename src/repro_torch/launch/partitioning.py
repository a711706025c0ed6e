"""Per-arch parallel plan: input specs, parameter / optimizer / cache
shardings and the rules, the twin of ``repro.launch.partitioning``.

``input_specs`` returns meta tensors (shapes and dtypes, no allocation)
for every model input of an (arch × shape) cell, as the reference returns
``ShapeDtypeStruct``s; ``abstract_params`` and ``abstract_cache`` are meta
trees too.  A sharding here is a ``models.sharding.P`` (the mesh is the
caller's), and every function gives the reference's spec leaf for leaf.
``plan`` on a mesh of ``"meta"`` entries lays a cell out without a
device, as ``launch.dryrun`` does on the production meshes.  It takes the
reference's ``cfg_replace`` (the dry run's depth points); the reference's
``unroll`` has no twin, since the port's layers run in a Python loop and
are counted one by one.  Where a shape name is taken, a ``ShapeConfig``
may stand in its place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import ShapeConfig, get_config, get_shape
from ..models import transformer as T
from ..models.sharding import (P, ShardingRules, axis_sizes, param_shardings,
                               tree_map)
from .mesh import batch_axes


def make_rules(cfg, mesh) -> ShardingRules:
    model_size = axis_sizes(mesh).get("model", 1)
    return ShardingRules(
        batch_axes=batch_axes(mesh),
        model_axis="model",
        shard_heads=(cfg.n_heads % model_size == 0),
        mesh=mesh,
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shape(shape) -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else get_shape(shape)


def input_specs(arch: str, shape_name, *, cfg=None) -> dict:
    """A meta tensor for every input of the cell's step function (``cfg``:
    the arch's config with its replacements, default the registry's)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = _shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    tokens_in = cfg.frontend == "none" or cfg.encoder_layers
    if shape.kind == "decode":
        batch = {"tokens": _meta((b, 1), i32)} if tokens_in else \
            {"embeds": _meta((b, 1, cfg.d_model), f32)}
    elif tokens_in:
        batch = {"tokens": _meta((b, s), i32)}
    else:
        batch = {"embeds": _meta((b, s, cfg.d_model), f32)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = _meta((b, cfg.encoder_seq, cfg.d_model), f32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), i32)
    return batch


def _n_batch(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[ax] for ax in batch_axes(mesh)]))


def batch_shardings(batch, mesh):
    """The batch dimension over the batch axes; replicated where it does
    not divide (``long_500k``'s batch of 1)."""
    ba, n = batch_axes(mesh), _n_batch(mesh)

    def spec(leaf):
        if leaf.shape[0] % n == 0:
            return P(ba, *([None] * (len(leaf.shape) - 1)))
        return P()
    return tree_map(spec, batch)


def abstract_params(cfg) -> dict:
    """The parameter tree in the reference's layout as meta tensors: no
    weight is drawn or allocated."""
    return T.Transformer(cfg, device="meta").param_tree()


def abstract_cache(cfg, batch_size: int, max_len: int):
    return T.init_cache(cfg, batch_size, max_len, device="meta")


def opt_shardings(p_shardings, params, mesh):
    """ZeRO-1: each optimizer moment also splits over the data axes, on the
    largest dimension they divide that the parameter's spec leaves free."""
    ba, n_data = batch_axes(mesh), _n_batch(mesh)

    def one(leaf, ps):
        spec = list(ps) + [None] * (len(leaf.shape) - len(ps))
        free = [i for i, s in enumerate(spec) if s is None
                and leaf.shape[i] % n_data == 0 and leaf.shape[i] > 1]
        if free:
            i = max(free, key=lambda j: leaf.shape[j])
            spec[i] = ba if len(ba) > 1 else ba[0]
        return P(*spec)
    return tree_map(one, params, p_shardings)


def cache_shardings(cfg, cache, mesh):
    """KV / state caches: dimension 1 (the batch, layers leading) over the
    data axes, and dimension 2 of a 5-d leaf (the kv heads of ``(L, B,
    Hkv, C, dh)``) over ``model``, each where it divides; the rest
    replicates.  The rule reads shapes only, as the reference's does."""
    ba, n_b = batch_axes(mesh), _n_batch(mesh)
    m = axis_sizes(mesh).get("model", 1)

    def spec(leaf):
        shp = leaf.shape
        dims = [None] * len(shp)
        if len(shp) >= 2 and shp[1] % n_b == 0 and shp[1] > 1:
            dims[1] = ba
        if len(shp) == 5 and shp[2] % m == 0:
            dims[2] = "model"
        return P(*dims)
    return tree_map(spec, cache)


def plan(arch: str, shape_name, mesh, *,
         cfg_replace: dict | None = None) -> dict:
    """Everything a step on ``mesh`` needs for one cell: the config (with
    ``cfg_replace``'s fields replaced), the shape, the rules, the batch's
    and the parameters' meta trees and specs, and for a decode cell the
    cache's."""
    cfg = get_config(arch)
    if cfg_replace:
        cfg = dataclasses.replace(cfg, **cfg_replace)
    shape = _shape(shape_name)
    batch = input_specs(arch, shape, cfg=cfg)
    p_abs = abstract_params(cfg)
    out = dict(cfg=cfg, shape=shape, rules=make_rules(cfg, mesh),
               batch=batch, batch_shardings=batch_shardings(batch, mesh),
               params=p_abs, param_shardings=param_shardings(p_abs, mesh))
    if shape.kind == "decode":
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        out["cache"] = cache
        out["cache_shardings"] = cache_shardings(cfg, cache, mesh)
    return out
