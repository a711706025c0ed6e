"""Step functions: the LM's train / prefill / serve steps and the GCN train
step.

Twins of ``repro.launch.steps`` without ``jit``: PyTorch runs eagerly.  The
LM train step differentiates the model's training forward
(``forward(..., train=True)``: ``scan_attention`` and ``cfg.remat``) with
autograd and updates its parameters in place with ``optim.adamw``; the
prefill and serve steps run under ``torch.inference_mode()``, so they
record no graph now that the parameters require grad.

Each LM step takes ``rules``: on a mesh of more than one entry the step
places the model's parameters by ``param_shardings`` once, when it is
made (``models.transformer.MeshExecutor``; the twin of the reference's
``jit(..., in_shardings=...)``), and every call runs on the mesh.  The
train step on a mesh averages each data shard's loss into the mean over
all rows, sums the gradients of every block over the members that hold
it, and runs AdamW under ZeRO-1 (``Zero1``: the moments laid out by
``opt_shardings``, each data member updating its chunk, an
``all_gather`` over the data axes rebuilding the parameter).
"""
from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..models import sharding
from ..models import transformer as T
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


def make_train_step(model, opt_cfg: adamw.OptConfig, *, impl: str = "cuda",
                    rules=None):
    """LM train step: ``step(opt_state, batch) -> (opt_state, metrics)``.

    It zeroes the gradients, runs the loss's backward and one
    ``adamw.update`` on the model's parameters in place, with the
    weight-decay set the model states (``model.decay_mask()``).
    A parameter the batch does not reach (the token embedding of a step
    on ``embeds``, ``frontend_proj`` of one on tokens) has no gradient,
    which ``adamw.update`` takes as zeros, as ``jax.grad`` gives them.
    ``metrics`` holds ``loss`` and ``grad_norm`` (0-d tensors; reading them
    waits for the device) and ``lr`` (a float).  Start from
    ``adamw.init(model.parameters())``.  Its spans
    (``repro_torch.tracing``), on a mesh or not: ``train_step`` around
    ``train_step.forward``, ``.backward`` and ``.update``.

    With ``rules`` on a mesh the step places copies of the parameters
    when it is made (``step.executor``; a later change to the model's
    parameters, a restore, needs a new step), trains them, and after each
    update writes them back into the model's parameters, which then hold
    what the unsharded step's in-place update leaves there.  The first
    call lays the state out as a ``MeshOptState``
    (``step.zero.gather(state)`` gives it whole)."""
    if T.on_mesh(rules):
        return _mesh_train_step(model, opt_cfg, impl, rules)
    loss_fn = make_loss_fn(model, impl=impl)
    params = list(model.parameters())
    decay = model.decay_mask()

    def train_step(opt_state, batch):
        with tracing.step():
            with tracing.span("train_step.forward"):
                for p in params:
                    p.grad = None
                loss, _ = loss_fn(batch)
            with tracing.span("train_step.backward"):
                loss.backward()
            with tracing.span("train_step.update"):
                opt_state, om = adamw.update(
                    opt_cfg, [p.grad for p in params], opt_state, params,
                    decay)
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
    for the device).  Its spans (``repro_torch.tracing``): ``train_step``
    around ``train_step.forward``, ``.backward`` and ``.update``."""
    def step(x, y):
        with tracing.step():
            with tracing.span("train_step.forward"):
                for w in model.weights:
                    w.grad = None
                loss = model.loss(x, y, backend=backend, mesh=mesh)
            with tracing.span("train_step.backward"):
                loss.backward()
            with tracing.span("train_step.update"), torch.no_grad():
                for w in model.weights:
                    w.sub_(lr * w.grad)
            return loss.detach()
    return step


def make_prefill_step(model, *, rules=None, gather: bool = True):
    """``prefill_step(batch) -> logits (B, S, V)``, ``batch`` as the model's
    ``forward`` takes it (tokens, or the reference's dict), under
    ``torch.inference_mode()``; with ``rules`` on a mesh, over it (the
    logits on its first device).  ``gather=False`` leaves the logits where
    the mesh computed them, as the reference's step leaves them sharded
    (``rules.logits``): member -> its block (the dry run's prefill)."""
    ex = T.MeshExecutor(model, rules) if T.on_mesh(rules) else None

    @torch.inference_mode()
    def prefill_step(batch):
        if ex is None:
            return model(batch)
        if not gather:
            return ex.member_logits(batch)
        return ex.forward(batch)
    prefill_step.executor = ex
    return prefill_step


def make_serve_step(model, *, rules=None):
    """``serve_step(batch, cache, cache_len) -> (next_tok (B,) int32,
    cache)``: one decode step, or the batched prefill when ``batch`` holds
    more than one position (tokens, or the reference's dict); greedy
    (first maximum on ties, as ``jnp.argmax``); under
    ``torch.inference_mode()``.  With ``rules`` on a mesh the cache is the
    model's ``init_cache(..., rules=rules)``."""
    ex = T.MeshExecutor(model, rules) if T.on_mesh(rules) else None

    @torch.inference_mode()
    def serve_step(batch, cache, cache_len: int):
        if ex is None:
            logits, cache = model.decode_step(batch, cache, cache_len)
        else:
            logits, cache = ex.decode_step(batch, cache, cache_len)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache
    serve_step.executor = ex
    return serve_step


# ------------------------------------------------------------ ZeRO-1 ----
class MeshOptState(NamedTuple):
    """AdamW's state on a mesh: for each parameter, member -> its f32
    moment chunk (None where the member holds none)."""
    step: int
    mu: list
    nu: list


class Zero1:
    """AdamW under ZeRO-1 on a ``MeshExecutor``'s trainable blocks.

    Each member holds the moment chunk ``opt_shardings`` gives it: its
    block of the parameter, split further over the data axes on the
    largest free dimension they divide (that dimension may be a layer
    axis of the stacked tree, and then a member holds whole layers or
    none); a moment with no such dimension is whole on every data
    member."""

    def __init__(self, ex):
        from .partitioning import opt_shardings
        self.ex = ex
        mesh = ex.rules.mesh
        specs = opt_shardings(sharding.param_shardings(ex.meta_tree, mesh),
                              ex.meta_tree, mesh)
        self.chunks = []
        for path, idx in ex.layout:
            leaf = functools.reduce(operator.getitem, path, ex.meta_tree)
            spec = functools.reduce(operator.getitem, path, specs)
            per = {}
            for j, m in ex.mem.all():
                reg = sharding.spec_region(leaf.shape, spec,
                                           ex.mem.coords[j][m],
                                           ex.mem.sizes)
                held = all(a <= i < b for i, (a, b) in zip(idx, reg))
                per[(j, m)] = reg[len(idx):] if held else None
            self.chunks.append(per)
        # the members holding each block of a parameter, and the distinct
        # chunks they hold with each one's first holder (member order)
        self.groups = []
        for k, per in enumerate(self.chunks):
            by_block = {}
            for who in ex.mem.all():
                holders, firsts = by_block.setdefault(ex.regions[who][k],
                                                      ([], {}))
                holders.append(who)
                if per[who] is not None:
                    firsts.setdefault(per[who], who)
            self.groups.append(list(by_block.values()))

    def _device(self, who):
        return self.ex.mem.devices[who[0]][who[1]]

    def place(self, state: adamw.OptState) -> MeshOptState:
        """An unsharded state (``adamw.init``'s, or a restored one) laid out
        on the members."""
        def lay(moments):
            return [{who: None if reg is None else
                     m[tuple(slice(a, b) for a, b in reg)].to(
                         self._device(who), torch.float32, copy=True)
                     for who, reg in per.items()}
                    for m, per in zip(moments, self.chunks)]
        return MeshOptState(state.step, lay(state.mu), lay(state.nu))

    def gather(self, state: MeshOptState) -> adamw.OptState:
        """The state whole, each moment on the mesh's first device."""
        def whole(moments):
            out = []
            for p, chunks, per in zip(self.ex.model.parameters(), moments,
                                      self.chunks):
                t = torch.zeros(p.shape, dtype=torch.float32,
                                device=self.ex.mem.first)
                for who, reg in per.items():
                    if reg is not None:
                        t[tuple(slice(a, b) for a, b in reg)] = \
                            chunks[who].to(t.device)
                out.append(t)
            return out
        return adamw.OptState(state.step, whole(state.mu), whole(state.nu))

    def _summed_grads(self, k: int) -> dict:
        """Member -> the gradient of its block of parameter ``k``, summed
        over every member holding that block (a ``psum``)."""
        ex, groups = self.ex, {}
        for who in ex.mem.all():
            groups.setdefault(ex.regions[who][k], []).append(who)
        out = {}
        for whos in groups.values():
            grads = [ex.pieces[w][k].grad for w in whos]
            if all(g is None for g in grads):
                res = [None] * len(whos)
            else:
                for i, (w, g) in enumerate(zip(whos, grads)):
                    if g is None:
                        with sharding.turn(w):
                            grads[i] = torch.zeros_like(ex.pieces[w][k])
                res = sharding.psum(grads, [self._device(w) for w in whos],
                                    whos)
            out.update({w: (r, i == 0) for i, (w, r) in
                        enumerate(zip(whos, res))})
        return out

    @torch.no_grad()
    def update(self, cfg: adamw.OptConfig, state: MeshOptState, decay):
        """One AdamW step on the members' blocks in place: the clip by the
        norm counting each block once, each chunk's update, then each
        member's block rebuilt from its data group's chunks."""
        ex = self.ex
        summed = [self._summed_grads(k) for k in range(len(self.chunks))]
        flat = [v for per in summed for v in per.values()]
        gnorm = adamw.global_norm([g for g, _ in flat],
                                  [own for _, own in flat])
        gnorm = sharding._to(gnorm, ex.mem.first)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr, b1c, b2c = adamw.step_factors(cfg, step)
        for k, per in enumerate(self.chunks):
            new = {}
            for who, reg in per.items():
                if reg is None:
                    continue
                rel = T._within(reg, ex.regions[who][k])
                g = summed[k][who][0]
                with sharding.turn(who):
                    new[who] = adamw.adam_chunk(
                        cfg, ex.pieces[who][k][rel],
                        None if g is None else g[rel], state.mu[k][who],
                        state.nu[k][who], decay[k],
                        scale=sharding._to(scale, self._device(who)), lr=lr,
                        b1c=b1c, b2c=b2c, in_place=False)
            # each member's block rebuilt from its data group's chunks: its
            # own first, then each other chunk from its first holder
            for holders, firsts in self.groups[k]:
                for who in holders:
                    target, held = ex.pieces[who][k], ex.regions[who][k]
                    own = per[who]
                    done = []
                    for reg in ([own] if own is not None else []) + \
                            [r for r in firsts if r != own]:
                        if any(T._overlap(reg, d) == reg for d in done):
                            continue
                        src = who if reg == own else firsts[reg]
                        with sharding.turn(who):
                            target[T._within(reg, held)] = new[src].to(
                                target.device, target.dtype)
                        if src != who:
                            sharding.count("all_gather", new[src].numel()
                                           * target.element_size())
                        done.append(reg)
        return (MeshOptState(step, state.mu, state.nu),
                {"grad_norm": gnorm, "lr": lr})


def _mesh_train_step(model, opt_cfg, impl, rules):
    ex = T.MeshExecutor(model, rules, trainable=True)
    zero = Zero1(ex)
    decay = model.decay_mask()
    leaves = [t for row in ex.pieces.values() for t in row]

    def train_step(opt_state, batch):
        with tracing.step():
            with tracing.span("train_step.forward"):
                if not isinstance(opt_state, MeshOptState):
                    opt_state = zero.place(opt_state)
                for t in leaves:
                    t.grad = None
                logits = ex.shard_logits(batch, impl=impl, train=True)
                rows = ex.mem.rows(batch["labels"].shape[0])
                n = ex.mem.n_data
                parts = []
                for j, lg in enumerate(logits):
                    with sharding.turn((j, 0)):
                        parts.append(cross_entropy(
                            lg, batch["labels"][rows[j]].to(lg.device)) / n)
                loss = sharding.psum(parts, [lg.device for lg in logits],
                                     [(j, 0) for j in range(n)])[0]
            with tracing.span("train_step.backward"):
                loss.backward()
            with tracing.span("train_step.update"):
                opt_state, om = zero.update(opt_cfg, opt_state, decay)
                ex.write_back()
            return opt_state, {"loss": loss.detach(), **om}
    train_step.executor, train_step.zero = ex, zero
    return train_step
