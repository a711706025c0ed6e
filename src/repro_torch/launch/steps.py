"""Step functions: the LM's train / prefill / serve steps and the GCN train
step.

Twins of ``repro.launch.steps`` without ``jit``: PyTorch runs eagerly.  The
LM train step differentiates the model's training forward
(``forward(..., train=True)``: ``scan_attention`` and ``cfg.remat``) with
autograd and updates its parameters in place with ``optim.adamw``; the
prefill and serve steps run under ``torch.inference_mode()``, so they
record no graph now that the parameters require grad.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean next-token negative log-likelihood, the softmax in f32 over the
    vocabulary (the reference's ``log_softmax`` + gather, one fused op)."""
    return F.cross_entropy(logits.float().flatten(0, -2),
                           labels.flatten().long())


def make_loss_fn(model, *, impl: str = "cuda"):
    """``loss_fn(batch) -> (loss, {"loss": loss})`` for the reference's
    batch dict, ``{"tokens" (B, S) | "embeds" (B, S, d), ["enc_embeds"],
    "labels" (B, S)}``, at the model's parameters, through its training
    forward."""
    def loss_fn(batch):
        logits = model(batch, impl=impl, train=True)
        loss = cross_entropy(logits, batch["labels"])
        return loss, {"loss": loss}
    return loss_fn


def make_train_step(model, opt_cfg: adamw.OptConfig, *, impl: str = "cuda"):
    """LM train step: ``step(opt_state, batch) -> (opt_state, metrics)``.

    It zeroes the gradients, runs the loss's backward and one
    ``adamw.update`` on the model's parameters in place, with the
    weight-decay set the model states (``model.decay_mask()``).
    A parameter the batch does not reach (the token embedding of a step
    on ``embeds``, ``frontend_proj`` of one on tokens) has no gradient,
    which ``adamw.update`` takes as zeros, as ``jax.grad`` gives them.
    ``metrics`` holds ``loss`` and ``grad_norm`` (0-d tensors; reading them
    waits for the device) and ``lr`` (a float).  Start from
    ``adamw.init(model.parameters())``."""
    loss_fn = make_loss_fn(model, impl=impl)
    params = list(model.parameters())
    decay = model.decay_mask()

    def train_step(opt_state, batch):
        for p in params:
            p.grad = None
        loss, _ = loss_fn(batch)
        loss.backward()
        opt_state, om = adamw.update(opt_cfg, [p.grad for p in params],
                                     opt_state, params, decay)
        return opt_state, {"loss": loss.detach(), **om}
    return train_step


def make_gcn_train_step(model, *, lr: float = 0.3, backend: str = "auto",
                        mesh=None):
    """SGD train step for a ``models.gcn.GCN``.

    The returned ``step(x, y) -> loss`` differentiates through
    ``tile_fused_matmul``'s autograd Functions, so the backward runs the
    transposed products off the cached transpose schedules on whatever
    backend ``backend`` (or Eq-3 auto selection) resolves to, then updates
    the weights in place, ``w ← w − lr·g``.  ``mesh=`` runs the forward
    and the backward's fused products over a mesh.  The loss returned is
    the one at the weights before the update (a tensor; reading it waits
    for the device)."""
    def step(x, y):
        for w in model.weights:
            w.grad = None
        loss = model.loss(x, y, backend=backend, mesh=mesh)
        loss.backward()
        with torch.no_grad():
            for w in model.weights:
                w.sub_(lr * w.grad)
        return loss.detach()
    return step


def make_prefill_step(model):
    """``prefill_step(batch) -> logits (B, S, V)``, ``batch`` as the model's
    ``forward`` takes it (tokens, or the reference's dict), under
    ``torch.inference_mode()``."""
    @torch.inference_mode()
    def prefill_step(batch):
        return model(batch)
    return prefill_step


def make_serve_step(model):
    """``serve_step(batch, cache, cache_len) -> (next_tok (B,) int32,
    cache)``: one decode step, or the batched prefill when ``batch`` holds
    more than one position (tokens, or the reference's dict); greedy
    (first maximum on ties, as ``jnp.argmax``); under
    ``torch.inference_mode()``."""
    @torch.inference_mode()
    def serve_step(batch, cache, cache_len: int):
        logits, cache = model.decode_step(batch, cache, cache_len)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache
    return serve_step
