"""Step functions of the LM: ``prefill_step`` and ``serve_step`` factories.

Twins of ``repro.launch.steps.make_prefill_step`` / ``make_serve_step``
without ``jit``: PyTorch runs eagerly.  Training steps come with the LM
training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch


def make_prefill_step(model):
    """``prefill_step(tokens (B, S)) -> logits (B, S, V)``."""
    def prefill_step(tokens):
        return model(tokens)
    return prefill_step


def make_serve_step(model):
    """``serve_step(tokens, cache, cache_len) -> (next_tok (B,) int32,
    cache)``: one decode step, or the batched prefill when ``tokens`` holds
    more than one position; greedy (first maximum on ties, as
    ``jnp.argmax``)."""
    def serve_step(tokens, cache, cache_len: int):
        logits, cache = model.decode_step(tokens, cache, cache_len)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache
    return serve_step
