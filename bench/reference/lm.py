"""Plain reference of the sparse-band LM's training step, in f32.

The model, pre-norm, ``L`` blocks of

    x ← x + ((A·(h·Wv)) ⊙ silu(h·Wz))·W_mix_down,   h = rms(x)·g1
    x ← x + (silu(h·Wg) ⊙ (h·Wu))·Wd,             h = rms(x)·g2

then ``logits = (rms(x)·g_f)·W_head`` over the token embeddings, and the
mean next-token cross-entropy.  ``A`` is the causal decay band of each
sequence: ``A[i, j] = (1 − a)·a^(i−j)`` for ``i − w < j ≤ i``, worked out
here again (dense, ``S × S``; its zeros add nothing).  ``rms(x) = x /
sqrt(mean(x²) + eps)``.

AdamW as the configuration states it: the gradient clipped by its global
norm, bias-corrected moments in f32, decoupled weight decay on every
block weight (the norm gains too), the embedding and the head, but not
``ln_f``; a linear warmup and a cosine to a tenth of the rate.  The
weights are kept in the configuration's dtype (each update computed in
f32, then stored), and every product computes in f32 from them.  The
batch runs a row at a time, so that the f32 activations fit beside the
program's freed memory.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import precision as P


def band(seq: int, window: int, decay: float, device) -> torch.Tensor:
    i = torch.arange(seq, device=device)
    lag = (i[:, None] - i[None, :]).float()
    inside = (lag >= 0) & (lag < window)
    return torch.where(inside, (1.0 - decay) * decay ** lag.clamp_min(0),
                       torch.zeros((), device=device))


def rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def row_loss(cfg, w, a_band, tokens, labels, prec):
    mm = lambda u, v: P.matmul(u, v, prec)  # noqa: E731
    eps = cfg["norm_eps"]
    x = w["tok.embed"][tokens]
    for i in range(cfg["n_layers"]):
        p = lambda k: w[f"blocks.{i}.{k}"]  # noqa: E731
        h = rms(x, p("ln1"), eps)
        mixed = mm(a_band, mm(h, p("mix.wv"))) * F.silu(mm(h, p("mix.wz")))
        x = x + mm(mixed, p("mix.w_down"))
        h = rms(x, p("ln2"), eps)
        x = x + mm(F.silu(mm(h, p("ffn.w_gate"))) * mm(h, p("ffn.w_up")),
                   p("ffn.w_down"))
    logits = mm(rms(x, w["ln_f"], eps), w["tok.lm_head"])
    return F.cross_entropy(logits, labels.long())


def decayed(name: str) -> bool:
    return name != "ln_f"


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(
        math.pi * prog)))


def train(cfg: dict, opt: dict, weights: dict, batches: list, *,
          prec: str = "f32", fault: str | None = None) -> dict:
    """AdamW steps from ``weights`` (name → tensor of the configuration's
    dtype; not changed), one a batch of ``batches`` (``{"tokens",
    "labels"}`` int tensors ``(B, S)`` on the weights' device).  Returns the
    readings the benchmark compares: each step's loss, each weight's first
    gradient as AdamW takes it (clipped) and its change after the last
    step (norms by name).  ``fault="half_batch"`` takes the mean over the
    first half of the rows only."""
    P.disable_tf32()
    dtype = getattr(torch, cfg["dtype"])
    names = list(weights)
    stored = {k: weights[k].detach().clone() for k in names}
    mu = {k: torch.zeros_like(t, dtype=torch.float32)
          for k, t in stored.items()}
    nu = {k: torch.zeros_like(t, dtype=torch.float32)
          for k, t in stored.items()}
    losses, first = [], None
    b1, b2 = opt["b1"], opt["b2"]
    for step, batch in enumerate(batches, start=1):
        w = {k: t.float().requires_grad_(True) for k, t in stored.items()}
        tokens, labels = batch["tokens"], batch["labels"]
        rows = tokens.shape[0] // 2 if fault == "half_batch" else \
            tokens.shape[0]
        a_band = band(tokens.shape[1], cfg["band_window"],
                      cfg["band_decay"], tokens.device)
        total = 0.0
        for r in range(rows):
            loss = row_loss(cfg, w, a_band, tokens[r], labels[r], prec) / rows
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {k: w[k].grad for k in names}
        del w
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
        lr = lr_at(opt, step)
        b1c, b2c = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for k in names:
                g = grads[k] * scale
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[k] / b1c) / ((nu[k] / b2c).sqrt() + opt["eps"])
                p32 = stored[k].float()
                if decayed(k):
                    upd += opt["weight_decay"] * p32
                stored[k] = (p32 - lr * upd).to(dtype)
                grads[k] = None
        if step == 1:
            first = {k: float(mu[k].norm()) / (1 - b1) for k in names}
    return {"losses": losses, "grad_norms": first,
            "change_norms": {k: float((stored[k].float()
                                       - weights[k].float()).norm())
                             for k in names}}
