"""Step functions: the GCN train step and the LM's prefill / serve steps.

Twins of ``repro.launch.steps.make_gcn_train_step``, ``make_prefill_step``
and ``make_serve_step`` without ``jit``: PyTorch runs eagerly.  The LM's
training steps come with the LM training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch


def make_gcn_train_step(model, *, lr: float = 0.3, backend: str = "auto"):
    """SGD train step for a ``models.gcn.GCN``.

    The returned ``step(x, y) -> loss`` differentiates through
    ``tile_fused_matmul``'s autograd Functions, so the backward runs the
    transposed products off the cached transpose schedules on whatever
    backend ``backend`` (or Eq-3 auto selection) resolves to, then updates
    the weights in place, ``w ← w − lr·g``.  The loss returned is the one
    at the weights before the update (a tensor; reading it waits for the
    device)."""
    def step(x, y):
        for w in model.weights:
            w.grad = None
        loss = model.loss(x, y, backend=backend)
        loss.backward()
        with torch.no_grad():
            for w in model.weights:
                w.sub_(lr * w.grad)
        return loss.detach()
    return step


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
