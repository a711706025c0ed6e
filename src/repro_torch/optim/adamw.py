"""AdamW with global-norm clipping and a warmup-cosine schedule.

The twin of ``repro.optim.adamw``, on lists of tensors.  ``update`` works in
place, PyTorch's idiom, where the reference returns a new tree: it computes
in f32 and casts back to each parameter's dtype; ``mu`` and ``nu`` are f32.
The step count and the learning rate stay on the host, so a step needs no
synchronize.

**The weight-decay set** is the model's to state: ``update`` takes one
bool a parameter.  The reference decays a leaf of rank 2 or more of its
parameter tree, in which every per-layer weight is stacked on a leading
layer axis, so the layers' norm gains are decayed and ``ln_f`` is not;
``models.transformer.Transformer.decay_mask`` gives that set.

``state_to_tree`` / ``state_from_tree`` carry the state to and from the
reference's ``OptState(step, mu, nu)`` tree (``step`` an int32 0-d, the
moments f32 in the parameter tree's layout), which is what a checkpoint
holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: int      # updates made so far
    mu: list       # f32 first moments, one a parameter
    nu: list       # f32 second moments


def init(params) -> OptState:
    """Zero moments (f32, on each parameter's device) and step 0."""
    params = list(params)
    return OptState(step=0, mu=[torch.zeros_like(p, dtype=torch.float32)
                                for p in params],
                    nu=[torch.zeros_like(p, dtype=torch.float32)
                        for p in params])


def schedule(cfg: OptConfig, step) -> float:
    """Linear warmup to ``cfg.lr``, then a cosine to a tenth of it."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tensors, owned=None) -> torch.Tensor:
    """``sqrt(Σ x²)`` over all tensors (``None`` counts as zeros), in f32
    (a 0-d tensor on the first tensor's device).  ``owned`` (one bool a
    tensor) counts only the owned ones: on a mesh each block of a
    parameter is held by several members, and only one of them counts
    it, so the norm is the unsharded step's."""
    tensors = list(tensors)
    owned = [True] * len(tensors) if owned is None else list(owned)
    sums = [x.float().square().sum() for x, own in zip(tensors, owned)
            if own and x is not None]
    if not sums:
        return torch.zeros(())
    dev = sums[0].device
    return torch.sqrt(sum(t.to(dev) for t in sums))


def adam_chunk(cfg: OptConfig, p, g, m, v, decay: bool, *, scale, lr: float,
               b1c: float, b2c: float, in_place: bool = True):
    """The AdamW update of one tensor (a parameter, or a mesh member's
    chunk of one): the moments ``m``, ``v`` in place; the new value
    written into ``p`` (``in_place``) or returned in f32.  ``g=None`` is
    zeros."""
    m.mul_(cfg.b1)
    v.mul_(cfg.b2)
    if g is not None:
        g = g.to(torch.float32, copy=True).mul_(scale)
        m.add_(g, alpha=1 - cfg.b1)
        v.addcmul_(g, g, value=1 - cfg.b2)
        del g
    step_ = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
    p32 = p.float()
    if decay:
        step_.add_(p32, alpha=cfg.weight_decay)
    if not in_place:
        return torch.sub(p32, step_, alpha=lr)
    p.copy_(p32.sub_(step_, alpha=lr))
    return p


def step_factors(cfg: OptConfig, step: int) -> tuple:
    """``(lr, b1c, b2c)`` of update number ``step`` (from 1)."""
    return (schedule(cfg, step), 1.0 - cfg.b1 ** step,
            1.0 - cfg.b2 ** step)


@torch.no_grad()
def update(cfg: OptConfig, grads, state: OptState, params, decay):
    """One AdamW step on ``params`` in place; returns ``(state, metrics)``
    with ``metrics = {"grad_norm": pre-clip norm (0-d tensor), "lr": float}``.
    ``decay`` holds one bool a parameter: whether weight decay applies.  A
    gradient of ``None`` (a parameter the loss does not reach) is zeros, as
    ``jax.grad`` gives it: the moments decay and weight decay applies.
    At most two f32 temporaries of a parameter's size are alive at a time
    (the embedding of a 150 k vocabulary at d 8192 is 5 GB in f32)."""
    params, grads = list(params), list(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr, b1c, b2c = step_factors(cfg, step)
    for p, g, m, v, dk in zip(params, grads, state.mu, state.nu, decay):
        adam_chunk(cfg, p, g, m, v, dk, scale=scale, lr=lr, b1c=b1c,
                   b2c=b2c)
    return OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                "lr": lr}


def state_to_tree(state: OptState, model) -> OptState:
    """The reference's ``OptState`` tree of ``state``: ``step`` an int32 0-d
    tensor, ``mu`` and ``nu`` in ``model.to_tree``'s layout (f32, the
    layers stacked)."""
    return OptState(step=torch.tensor(state.step, dtype=torch.int32),
                    mu=model.to_tree(state.mu), nu=model.to_tree(state.nu))


def state_from_tree(tree, model) -> OptState:
    """The inverse of ``state_to_tree``: from a ``(step, mu, nu)`` tree of
    tensors (as ``checkpoint.restore`` gives it), the moments as fresh f32
    tensors, one a parameter on its device."""
    step, mu, nu = tree
    params = list(model.parameters())

    def moments(t):
        return [m.to(device=p.device, dtype=torch.float32, copy=True)
                for p, m in zip(params, model.from_tree(t))]
    return OptState(step=int(step), mu=moments(mu), nu=moments(nu))
