"""Architecture registry of the port: ``--arch <id>`` resolves here.

The port serves the architectures whose every layer it has: the dense
decoders (self-attention with GQA and optional QKV bias, gated FFN):
``qwen2.5-3b``, ``stablelm-1.6b`` and ``minitron-8b``; the MoE
decoders (the same attention, then the gated top-k MoE layer with its
capacity dispatch): ``granite-moe-3b-a800m`` (40 experts, top-8) and
``llama4-scout-17b-a16e`` (16 experts, top-1 plus a shared expert,
window 8192); ``minicpm3-4b`` (multi-head latent attention, a rank-256
latent cache); and ``hymba-1.5b`` (the attention + mamba hybrid block:
sliding-window GQA beside mamba heads on the chunked linear recurrence).
The other names of the JAX registry raise ``NotImplementedError`` naming
what they still need (ROADMAP Queue 1, the LM stack).
"""
from __future__ import annotations

from . import (granite_moe_3b, hymba_1_5b, llama4_scout, minicpm3_4b,
               minitron_8b, qwen2_5_3b, stablelm_1_6b)
from .base import ModelConfig

_MODULES = {
    "stablelm-1.6b": stablelm_1_6b,
    "minitron-8b": minitron_8b,
    "qwen2.5-3b": qwen2_5_3b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "llama4-scout-17b-a16e": llama4_scout,
    "minicpm3-4b": minicpm3_4b,
    "hymba-1.5b": hymba_1_5b,
}

#: architectures of the JAX registry that a later slice brings, and the
#: layers each waits for
LATER = {
    "whisper-medium": "the encoder and cross-attention",
    "xlstm-1.3b": "the mLSTM / sLSTM blocks",
    "qwen2-vl-72b": "the vision frontend",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name in LATER:
        raise NotImplementedError(
            f"{name} is not in the port yet: it needs {LATER[name]} "
            f"(ROADMAP Queue 1, the LM stack); the port serves "
            f"{ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.REDUCED if reduced else mod.CONFIG


__all__ = ["ARCH_NAMES", "get_config", "ModelConfig"]
