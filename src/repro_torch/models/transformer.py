"""Decoder-only LM, pre-norm, as in ``repro.models.transformer``, of three
block patterns: ``attn`` (self-attention, then a gated FFN, or the gated
top-k MoE layer when ``cfg.n_experts`` is set; the attention is GQA, or
multi-head latent attention when ``cfg.mla`` is set), ``attn+mamba``
(hymba's hybrid: sliding-window GQA and the mamba heads of ``models.ssm``
in parallel on one normed input, averaged, then a gated FFN) and
``sparse-band`` (the banded-decay token mixer of ``models.ssm``, then a
gated FFN).

The reference stacks its layers on a leading scan axis of one pytree; here
the blocks are an ``nn.ModuleList`` and the layers run in a Python loop.
``params_from_jax`` loads the reference's stacked tree, so both packages
can compute the same model.  The decode caches keep the reference's
layouts and ``decode_step`` writes into them in place: ``(k, v)`` each
``(L, B, Hkv, C, dh)`` for GQA; the latent ``(L, B, max_len, r)`` for
MLA; ``(k, v, state)`` for the hybrid, the mamba state ``(L, B, H, n,
dh)`` in f32.

The parameters are trainable and ``forward`` follows the caller's grad
mode: ``launch.steps.make_train_step`` trains the model with AdamW, and the
serving steps run under ``torch.inference_mode()``.  A training forward is
asked for explicitly, ``forward(tokens, train=True)``, never inferred from
the grad mode.  In it the attention (GQA, MLA, the hybrid's) is
``layers.scan_attention``, the reference's own chunked XLA attention in
plain PyTorch (the flash kernel has no backward and its wrapper raises
under grad on the card), and a ``sparse-band`` block's mixer
differentiates through ``tile_fused_matmul``'s kernels.  Each block of a
training forward runs under ``cfg.remat``, the twin of the reference's
``_maybe_remat``: ``"none"`` keeps every activation, ``"full"``
recomputes the whole block in the backward, and ``"dots"`` (every
full-width config) keeps only the 2-D projections' outputs (``aten.mm`` /
``aten.addmm``, the reference's ``dots_with_no_batch_dims_saveable``) and
recomputes the rest, the attention's batched products included.

The ``mlstm7+slstm`` pattern and the encoder raise
``NotImplementedError``: later slices bring them (ROADMAP Queue 1).
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import ssm as S

#: the block patterns the port runs
BLOCK_PATTERNS = ("attn", "attn+mamba", "sparse-band")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    missing = [what for what, off in [
        (f"block pattern {cfg.block_pattern!r}",
         cfg.block_pattern in BLOCK_PATTERNS),
        ("an encoder", not cfg.encoder_layers),
        (f"a {cfg.frontend} frontend", cfg.frontend == "none"),
    ] if not off]
    if missing:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(missing)}, which the port does not "
            f"have yet (ROADMAP Queue 1, the LM stack)")


#: the ops whose outputs ``remat="dots"`` keeps for the backward: the 2-D
#: products, as ``dots_with_no_batch_dims_saveable`` keeps the dots without
#: batch dimensions; ``bmm`` (the attention's einsums) is recomputed
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn):
    """``fn`` wrapped in the remat ``policy`` (``"none"`` | ``"full"`` |
    ``"dots"``): ``torch.utils.checkpoint`` without reentry, with the
    selective policy for ``"dots"``."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _dots_policy))
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                     f"{policy!r}")


def _params(d: dict) -> nn.ParameterDict:
    """A (nested) dict of tensors as parameters; a nested dict, such as the
    MoE layer's ``shared`` expert, becomes a nested ``ParameterDict``."""
    return nn.ParameterDict({
        k: _params(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in d.items()})


def _keys(node):
    """The key structure of a (nested) dict or ``ParameterDict``."""
    if isinstance(node, (dict, nn.ParameterDict)):
        return {k: _keys(v) for k, v in node.items()}
    return None


def _gain(cfg, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + ffn(norm(x))``,
    or ``x + moe(norm(x))`` when ``cfg.n_experts`` is set (the parameters
    ``moe`` in place of ``ffn``, as the reference's ``_attn_block_init``
    holds them).  The attention is MLA when ``cfg.mla`` is set (its
    parameters under ``attn`` too), else GQA."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln1 = _gain(cfg, dtype, device)
        self.ln2 = _gain(cfg, dtype, device)
        init = L.mla_init if cfg.mla else L.gqa_init
        self.attn = _params(init(gen, cfg, dtype, device))
        if cfg.n_experts:
            self.moe = _params(L.moe_init(gen, cfg, dtype, device))
        else:
            self.ffn = _params(L.ffn_init(gen, cfg, dtype, device))

    def forward(self, cfg, x, pos, cache=None, cache_len=None,
                impl="cuda", train=False):
        h = L.rms_norm(self.ln1, x, cfg.norm_eps)
        if cfg.mla:
            a, new_cache = L.mla_attention(self.attn, cfg, h, pos=pos,
                                           cache=cache, cache_len=cache_len,
                                           impl=impl, train=train)
        else:
            a, new_cache = L.gqa_attention(self.attn, cfg, h, pos=pos,
                                           cache=cache, cache_len=cache_len,
                                           window=cfg.window, impl=impl,
                                           train=train)
        x = x + a
        h = L.rms_norm(self.ln2, x, cfg.norm_eps)
        if cfg.n_experts:
            return x + L.moe_apply(self.moe, cfg, h), new_cache
        return x + L.ffn_apply(self.ffn, cfg, h), new_cache


class HybridBlock(nn.Module):
    """hymba's pre-norm block: ``x + (attn(h) + mamba(h)) / 2`` on one
    ``h = norm(x)``, the attention GQA under ``cfg.window``, then ``x +
    ffn(norm(x))``.  With ``cache = (k, v, state)``, this layer's KV slabs
    and mamba state, all three are written in place."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln1 = _gain(cfg, dtype, device)
        self.ln2 = _gain(cfg, dtype, device)
        self.attn = _params(L.gqa_init(gen, cfg, dtype, device))
        self.mamba = _params(S.mamba_init(gen, cfg, dtype, device))
        self.ffn = _params(L.ffn_init(gen, cfg, dtype, device))

    def forward(self, cfg, x, pos, cache=None, cache_len=None,
                impl="cuda", train=False):
        h = L.rms_norm(self.ln1, x, cfg.norm_eps)
        a, _ = L.gqa_attention(self.attn, cfg, h, pos=pos,
                               cache=None if cache is None else cache[:2],
                               cache_len=cache_len, window=cfg.window,
                               impl=impl, train=train)
        m, state = S.mamba_apply(self.mamba, cfg, h,
                                 cache=None if cache is None else cache[2])
        if cache is not None:
            cache[2].copy_(state)
        x = x + (a + m) * 0.5
        h = L.rms_norm(self.ln2, x, cfg.norm_eps)
        return x + L.ffn_apply(self.ffn, cfg, h), cache


class SparseBandBlock(nn.Module):
    """Pre-norm block: ``x + band_mix(norm(x))``, then ``x + ffn(norm(x))``.
    No decode cache: the band needs the whole (pre-)fill window."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln1 = _gain(cfg, dtype, device)
        self.ln2 = _gain(cfg, dtype, device)
        self.mix = _params(S.band_mix_init(gen, cfg, dtype, device))
        self.ffn = _params(L.ffn_init(gen, cfg, dtype, device))

    def forward(self, cfg, x, a_band, impl="cuda"):
        h = L.rms_norm(self.ln1, x, cfg.norm_eps)
        x = x + S.band_mix_apply(self.mix, cfg, h, a_band, backend=impl)
        h = L.rms_norm(self.ln2, x, cfg.norm_eps)
        return x + L.ffn_apply(self.ffn, cfg, h)


class Transformer(nn.Module):
    """The LM.  ``device=None`` means ``"cuda"``, and building the model
    raises when there is no card: it never drops to the CPU on its own
    (pass ``device="cpu"`` for that).  Weights are drawn on the model's
    device from a ``torch.Generator`` seeded with ``seed`` (the reference's
    distributions, not its numbers); ``params_from_jax`` loads the
    reference's weights instead.  ``impl="torch"`` runs prefill attention
    through the plain version of the flash kernel, and the band mixer
    through the plain fused executor (``backend="torch"``), on any
    device."""

    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        check_supported(cfg)
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Transformer runs on the card by default and "
                               "found no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.tok = _params(L.embed_init(gen, cfg, self.dtype, device))
        self.ln_f = _gain(cfg, self.dtype, device)
        block = {"sparse-band": SparseBandBlock,
                 "attn+mamba": HybridBlock}.get(cfg.block_pattern, Block)
        self.blocks = nn.ModuleList(block(cfg, gen, self.dtype, device)
                                    for _ in range(cfg.n_layers))

    @property
    def sparse_band(self) -> bool:
        return self.cfg.block_pattern == "sparse-band"

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def decay_mask(self) -> list:
        """The weight-decay set, one bool a parameter in ``parameters()``
        order: the reference's rule, ``ndim >= 2``, on the rank each
        parameter has in its stacked tree.  A block's parameter is stacked
        on the layer axis there, so every one is decayed, the norm gains
        ``ln1`` / ``ln2`` too; of the rest ``tok`` is and ``ln_f`` is not,
        although the reference's comment says "norms/bias exempt" (ROADMAP
        Queue 3)."""
        stacked = {id(p) for p in self.blocks.parameters()}
        return [p.dim() + (id(p) in stacked) >= 2 for p in self.parameters()]

    def from_tree(self, tree) -> list:
        """The leaves of a tree in the reference's layout (``init_params``'s
        keys, each block weight stacked on a leading layer axis), one a
        parameter in ``parameters()`` order: row ``i`` of a stacked leaf
        for block ``i``.  Raises ``ValueError`` for other keys or another
        layer count.  The inverse of ``to_tree``."""
        expected = {"tok", "ln_f", "layers"}
        if set(tree) != expected:
            raise ValueError(f"keys {sorted(tree)}, expected "
                             f"{sorted(expected)}")
        layers = tree["layers"]
        block = {name.split(".")[0]
                 for name, _ in self.blocks[0].named_parameters()}
        if set(layers) != block:
            raise ValueError(f"layer keys {sorted(layers)}, expected "
                             f"{sorted(block)}")
        n = len(layers["ln1"])
        if n != len(self.blocks):
            raise ValueError(f"{n} layers for {len(self.blocks)} blocks")

        for dst, src in [(self.tok, tree["tok"])] + [
                (getattr(self.blocks[0], k), layers[k]) for k in sorted(block)
                if isinstance(getattr(self.blocks[0], k), nn.ParameterDict)]:
            if _keys(dst) != _keys(src):
                raise ValueError(f"keys {_keys(src)} for {_keys(dst)}")

        def leaf(name):
            path = name.split(".")
            if path[0] != "blocks":
                return functools.reduce(operator.getitem, path, tree)
            return functools.reduce(operator.getitem, path[2:],
                                    layers)[int(path[1])]
        return [leaf(name) for name, _ in self.named_parameters()]

    def to_tree(self, tensors) -> dict:
        """One tensor a parameter, in ``parameters()`` order, as a tree in
        the reference's layout: the blocks' tensors stacked on a leading
        layer axis (the AdamW moments take the same form)."""
        named = dict(zip((n for n, _ in self.named_parameters()), tensors))
        layers = {}
        for name, _ in self.blocks[0].named_parameters():
            *path, leaf = name.split(".")
            node = layers
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.stack([named[f"blocks.{i}.{name}"]
                                      for i in range(len(self.blocks))])
        return {"tok": {k: named[f"tok.{k}"] for k in self.tok},
                "ln_f": named["ln_f"], "layers": layers}

    @torch.no_grad()
    def param_tree(self) -> dict:
        """The parameters as the reference's ``init_params`` tree: tensors
        of the model's dtype on its device, the layers stacked."""
        return self.to_tree(p.detach() for p in self.parameters())

    def params_to_jax(self) -> dict:
        """The inverse of ``params_from_jax``: the parameter tree as nested
        numpy arrays.  numpy has no bf16, so bf16 parameters come back
        widened to f32, exactly; ``params_from_jax`` takes them back bit
        for bit (``param_tree`` keeps the dtype)."""
        def to_numpy(node):
            if isinstance(node, dict):
                return {k: to_numpy(v) for k, v in node.items()}
            t = node.cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return to_numpy(self.param_tree())

    @torch.no_grad()
    def params_from_jax(self, params) -> None:
        """Copy the reference's ``init_params(cfg, key)`` tree (arrays,
        numpy arrays or tensors; layer weights stacked on a leading layer
        axis)."""
        for dst, src in zip(self.parameters(), self.from_tree(params)):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} for a parameter "
                                 f"of shape {tuple(dst.shape)}")
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src, np.float32))
            dst.copy_(src)

    def forward(self, tokens: torch.Tensor, *, impl: str = "cuda",
                train: bool = False):
        """tokens ``(B, S)`` → logits ``(B, S, V)``; records a graph when
        grad mode is on, none under ``inference_mode``.  ``train=True`` is
        a training forward: ``scan_attention`` in the ``attn`` and
        ``attn+mamba`` blocks and each block under ``cfg.remat``."""
        cfg = self.cfg
        x = self.tok["embed"][tokens]
        if self.sparse_band:
            a_band = S.decay_band_csr(x.shape[1], cfg.band_window,
                                      cfg.band_decay)

            def run(blk, x):
                return blk(cfg, x, a_band, impl=impl)
        else:
            pos = torch.arange(x.shape[1], device=x.device)

            def run(blk, x):
                return blk(cfg, x, pos, impl=impl, train=train)[0]
        if train:
            run = remat(cfg.remat, run)
        for blk in self.blocks:
            x = run(blk, x)
        x = L.rms_norm(self.ln_f, x, self.cfg.norm_eps)
        return x @ self.tok["lm_head"]

    def _check_decode(self) -> None:
        if self.sparse_band:
            raise NotImplementedError(
                "sparse-band blocks have no decode cache; serve via "
                "forward()")

    def init_cache(self, batch_size: int, max_len: int):
        """Zeros in the reference's layout of the model's cache family:
        ``(k, v)``, each ``(L, B, Hkv, C, dh)`` (``C`` is ``max_len``, or
        the window for a sliding-window model); for MLA the latent ``(L, B,
        max_len, r)``; for ``attn+mamba`` ``(k, v, state)`` with the mamba
        state ``(L, B, H, n, dh)`` in f32."""
        cfg = self.cfg
        self._check_decode()

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if cfg.mla:
            return zeros(cfg.n_layers, batch_size, max_len, cfg.mla_kv_rank)
        c = min(max_len, cfg.window) if cfg.window > 0 else max_len
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, c, cfg.head_dim)
        kv = (zeros(*shape), zeros(*shape))
        if cfg.block_pattern == "attn+mamba":
            return kv + (zeros(cfg.n_layers, batch_size, cfg.n_heads,
                               cfg.ssm_state, cfg.ssm_head_dim,
                               dtype=torch.float32),)
        return kv

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache, cache_len: int, *,
                    impl: str = "cuda"):
        """One decode step (S == 1), or a batched prefill that fills an
        empty cache (S > 1, ``cache_len == 0``).  Writes the cache in place;
        returns ``(logits (B, S, V), cache)``."""
        self._check_decode()
        x = self.tok["embed"][tokens]
        s = x.shape[1]
        pos = cache_len + torch.arange(s, device=x.device)
        for i, blk in enumerate(self.blocks):
            layer = cache[i] if self.cfg.mla else tuple(c[i] for c in cache)
            x, _ = blk(self.cfg, x, pos, cache=layer, cache_len=cache_len,
                       impl=impl)
        x = L.rms_norm(self.ln_f, x, self.cfg.norm_eps)
        return x @ self.tok["lm_head"], cache
