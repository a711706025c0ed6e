"""Architecture registry of the port: ``--arch <id>`` resolves here, for
every name of the JAX registry.

The dense decoders (self-attention with GQA and optional QKV bias, gated
FFN): ``qwen2.5-3b``, ``stablelm-1.6b`` and ``minitron-8b``; the MoE
decoders (the same attention, then the gated top-k MoE layer with its
capacity dispatch): ``granite-moe-3b-a800m`` (40 experts, top-8) and
``llama4-scout-17b-a16e`` (16 experts, top-1 plus a shared expert,
window 8192); ``minicpm3-4b`` (multi-head latent attention, a rank-256
latent cache); ``hymba-1.5b`` (the attention + mamba hybrid block:
sliding-window GQA beside mamba heads on the chunked linear recurrence);
``xlstm-1.3b`` (groups of 7 mLSTM blocks and an sLSTM block);
``whisper-medium`` (an encoder over stubbed audio frames, and a decoder
with cross-attention); and ``qwen2-vl-72b`` (a GQA decoder that also
takes stubbed vision embeddings).
"""
from __future__ import annotations

from . import (granite_moe_3b, hymba_1_5b, llama4_scout, minicpm3_4b,
               minitron_8b, qwen2_5_3b, qwen2_vl_72b, stablelm_1_6b,
               whisper_medium, xlstm_1_3b)
from .base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "whisper-medium": whisper_medium,
    "stablelm-1.6b": stablelm_1_6b,
    "minicpm3-4b": minicpm3_4b,
    "minitron-8b": minitron_8b,
    "qwen2.5-3b": qwen2_5_3b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "llama4-scout-17b-a16e": llama4_scout,
    "xlstm-1.3b": xlstm_1_3b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "hymba-1.5b": hymba_1_5b,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells():
    """All (arch, shape) cells, without the shapes a config skips."""
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            if shape_name in cfg.skip_shapes:
                continue
            out.append((arch, shape_name))
    return out


__all__ = ["ARCH_NAMES", "SHAPES", "get_config", "get_shape", "cells",
           "ModelConfig", "ShapeConfig"]
