"""The LM, pre-norm, as in ``repro.models.transformer``, of four block
patterns: ``attn`` (self-attention, then a gated FFN, or the gated top-k
MoE layer when ``cfg.n_experts`` is set; the attention is GQA, or
multi-head latent attention when ``cfg.mla`` is set), ``attn+mamba``
(hymba's hybrid: sliding-window GQA and the mamba heads of ``models.ssm``
in parallel on one normed input, averaged, then a gated FFN),
``sparse-band`` (the banded-decay token mixer of ``models.ssm``, then a
gated FFN) and ``mlstm7+slstm`` (xLSTM: groups of 7 mLSTM blocks and one
sLSTM block).  An ``attn`` model with ``cfg.encoder_layers`` is an
encoder-decoder: the encoder is a stack of non-causal ``attn`` blocks over
the projected ``enc_embeds``, and each decoder block adds cross-attention
over its output after the self-attention.  A model with ``cfg.frontend``
projects stubbed modality embeddings (``embeds``, ``enc_embeds``) into
``d_model`` with ``frontend_proj``.

Inputs are the reference's batch dict, ``{"tokens" (B, S) | "embeds" (B,
S, d), ["enc_embeds" (B, Se, d)]}`` (other keys, such as ``labels``, are
ignored); a tensor is taken as the tokens.  ``tokens`` and ``embeds`` are
interchangeable call by call: a prefill may take embeddings and the
decode steps tokens.

The reference stacks its layers on a leading scan axis of one pytree; here
the blocks are ``nn.ModuleList``s and the layers run in a Python loop.
``params_from_jax`` loads the reference's stacked tree (xLSTM's mLSTM
leaves stacked on two axes, ``(groups, 7, ...)``), so both packages can
compute the same model.  The decode caches keep the reference's layouts
and ``decode_step`` writes into them in place: ``(k, v)`` each ``(L, B,
Hkv, C, dh)`` for GQA; the latent ``(L, B, max_len, r)`` for MLA; ``(k,
v, state)`` for the hybrid, the mamba state ``(L, B, H, n, dh)`` in f32;
for xLSTM ``{"mlstm": (g, 7, B, H, dh, dh + 1), "slstm": (c, hid) each
(g, B, inner)}``, all f32.  An encoder-decoder's ``decode_step`` runs the
encoder again on every call, as the reference's does.

The parameters are trainable and ``forward`` follows the caller's grad
mode: ``launch.steps.make_train_step`` trains the model with AdamW, and the
serving steps run under ``torch.inference_mode()``.  A training forward is
asked for explicitly, ``forward(batch, train=True)``, never inferred from
the grad mode.  In it the attention (GQA, MLA, the hybrid's, the encoder's
and the cross-attention) is ``layers.scan_attention``, the reference's own
chunked XLA attention in plain PyTorch (the flash kernel has no backward
and its wrapper raises under grad on the card), and a ``sparse-band``
block's mixer differentiates through ``tile_fused_matmul``'s kernels.
Each block of a training forward (of xLSTM, each mLSTM block; its sLSTM
blocks run outside, as in the reference) runs under ``cfg.remat``, the
twin of the reference's ``_maybe_remat``: ``"none"`` keeps every
activation, ``"full"`` recomputes the whole block in the backward, and
``"dots"`` (every full-width config) keeps only the 2-D projections'
outputs (``aten.mm`` / ``aten.addmm``, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, the
attention's batched products included.

On a mesh the LM runs through ``MeshExecutor``: the reference's GSPMD
layout (``param_shardings``, ``cache_shardings`` and the activation specs
of ``ShardingRules``) computed one mesh member at a time, with explicit
collectives (``models.sharding``).  The executor places the parameters
once, when it is made, so ``forward`` and ``decode_step`` take ``rules``
only on a mesh of one entry; over a larger mesh the steps of
``launch.steps`` (given ``rules``) or an executor run them, and
``init_cache(..., rules=)`` lays out the cache.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import sharding
from . import ssm as S

#: the block patterns the port runs
BLOCK_PATTERNS = ("attn", "attn+mamba", "sparse-band", "mlstm7+slstm")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a block pattern the port does not
    run, and ``ValueError`` for an xLSTM depth that is not whole groups of
    8 layers."""
    if cfg.block_pattern not in BLOCK_PATTERNS:
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern!r} is not one of "
            f"{BLOCK_PATTERNS}")
    if cfg.block_pattern == "mlstm7+slstm" and cfg.n_layers % 8:
        raise ValueError(f"{cfg.name}: the xLSTM pattern needs n_layers % 8 "
                         f"== 0, got {cfg.n_layers}")


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
    parameters under ``attn`` too), else GQA.  A decoder block of an
    encoder-decoder (``cross=True``) adds ``x + xattn(norm(x), enc_out)``
    after the self-attention, its parameters ``ln_x`` and ``xattn``."""

    def __init__(self, cfg, gen, dtype, device, cross=False):
        super().__init__()
        self.ln1 = _gain(cfg, dtype, device)
        self.ln2 = _gain(cfg, dtype, device)
        init = L.mla_init if cfg.mla else L.gqa_init
        self.attn = _params(init(gen, cfg, dtype, device))
        if cross:
            self.ln_x = _gain(cfg, dtype, device)
            self.xattn = _params(L.gqa_init(gen, cfg, dtype, device))
        if cfg.n_experts:
            self.moe = _params(L.moe_init(gen, cfg, dtype, device))
        else:
            self.ffn = _params(L.ffn_init(gen, cfg, dtype, device))

    def forward(self, cfg, x, pos, cache=None, cache_len=None,
                impl="cuda", train=False, enc_out=None):
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
        if enc_out is not None:
            h = L.rms_norm(self.ln_x, x, cfg.norm_eps)
            x = x + L.cross_attention(self.xattn, cfg, h, enc_out, impl=impl,
                                      train=train)
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


def _mlstm_block(cfg, p, ln, x):
    """``x + mlstm(norm(x))`` without a state: a training forward's block."""
    return x + S.mlstm_apply(p, cfg, L.rms_norm(ln, x, cfg.norm_eps))[0]


class XLSTMGroup(nn.Module):
    """One xLSTM group: 7 pre-norm mLSTM blocks ``x + mlstm(norm(x))``,
    then a pre-norm sLSTM block.  The parameters keep the reference's
    names: ``mlstm`` and ``ln_m`` (7 each), ``slstm`` and ``ln_s``.  With
    ``cache = (mlstm states (7, B, H, dh, dh + 1), (c, hid))``, this
    group's slabs, every state is carried in and written back in place.
    Under ``train=True`` the mLSTM blocks run under ``cfg.remat`` and the
    sLSTM outside it, as in the reference."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.mlstm = nn.ModuleList(_params(S.mlstm_init(gen, cfg, dtype,
                                                        device))
                                   for _ in range(7))
        self.ln_m = nn.ParameterList(_gain(cfg, dtype, device)
                                     for _ in range(7))
        self.slstm = _params(S.slstm_init(gen, cfg, dtype, device))
        self.ln_s = _gain(cfg, dtype, device)

    def forward(self, cfg, x, cache=None, train=False):
        block = functools.partial(_mlstm_block, cfg)
        if train:
            block = remat(cfg.remat, block)
        for j, (p, ln) in enumerate(zip(self.mlstm, self.ln_m)):
            if cache is None:
                x = block(p, ln, x)
                continue
            y, state = S.mlstm_apply(p, cfg, L.rms_norm(ln, x, cfg.norm_eps),
                                     cache=cache[0][j])
            cache[0][j].copy_(state)
            x = x + y
        h = L.rms_norm(self.ln_s, x, cfg.norm_eps)
        y, carry = S.slstm_apply(self.slstm, cfg, h,
                                 cache=None if cache is None else cache[1])
        if cache is not None:
            for slab, new in zip(cache[1], carry):
                slab.copy_(new)
        return x + y


#: module names of the parameters → the reference tree's keys (None: no
#: key of its own, only a stacking axis)
_TREE_NAMES = {"blocks": "layers", "enc_blocks": "enc_layers",
               "groups": None}


def _stack(entries: dict) -> torch.Tensor:
    """``{index tuple: tensor}`` → one tensor stacked on ``len(index)``
    leading axes, in index order."""
    if () in entries:
        return entries[()]
    heads = sorted({i[0] for i in entries})
    return torch.stack([_stack({i[1:]: t for i, t in entries.items()
                                if i[0] == h}) for h in heads])


def _nest(pairs) -> dict:
    """``(path, value)`` pairs as a nested dict: ``value`` at
    ``tree[path[0]][path[1]]...``."""
    tree = {}
    for path, value in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def _as_batch(batch) -> dict:
    """The reference's batch dict; a tensor is taken as the tokens."""
    return {"tokens": batch} if isinstance(batch, torch.Tensor) else batch


def init_cache(cfg, batch_size: int, max_len: int, *, device=None):
    """Zeros in the reference's layout of ``cfg``'s cache family (its
    ``init_cache``): ``(k, v)``, each ``(L, B, Hkv, C, dh)`` (``C`` is
    ``max_len``, or the window for a sliding-window model); for MLA the
    latent ``(L, B, max_len, r)``; for ``attn+mamba`` ``(k, v, state)``
    with the mamba state ``(L, B, H, n, dh)`` in f32; for xLSTM ``{"mlstm":
    (g, 7, B, H, dh, dh + 1), "slstm": (c, hid)}``, the sLSTM's ``(g, B,
    inner)``, all f32, whatever ``max_len``.  ``device="meta"`` allocates
    nothing.  A ``sparse-band`` model has no cache (``NotImplementedError``,
    as the reference raises)."""
    if cfg.block_pattern == "sparse-band":
        raise NotImplementedError(
            "sparse-band blocks have no decode cache; serve via forward()")
    dtype = getattr(torch, cfg.dtype)

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    if cfg.block_pattern == "mlstm7+slstm":
        g, h, dh = cfg.n_layers // 8, cfg.n_heads, cfg.ssm_head_dim
        f32 = torch.float32
        return {"mlstm": zeros(g, 7, batch_size, h, dh, dh + 1, dtype=f32),
                "slstm": tuple(zeros(g, batch_size, h * dh, dtype=f32)
                               for _ in range(2))}
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
        # a meta model (shapes only, ``launch.partitioning.abstract_params``)
        # draws nothing: a generator cannot live on the meta device
        gen = None if device.type == "meta" else \
            torch.Generator(device=device).manual_seed(seed)
        self.tok = _params(L.embed_init(gen, cfg, self.dtype, device))
        self.ln_f = _gain(cfg, self.dtype, device)
        if cfg.frontend != "none":
            # the stubbed modality frontend: precomputed frame / patch
            # embeddings are projected into d_model
            self.frontend_proj = nn.Parameter(L.init_weight(
                gen, (cfg.d_model, cfg.d_model), dtype=self.dtype,
                device=device))
        if self.xlstm:
            self.groups = nn.ModuleList(
                XLSTMGroup(cfg, gen, self.dtype, device)
                for _ in range(cfg.n_layers // 8))
            return
        block = {"sparse-band": SparseBandBlock,
                 "attn+mamba": HybridBlock}.get(cfg.block_pattern, Block)
        if cfg.encoder_layers:
            block = functools.partial(Block, cross=True)
        self.blocks = nn.ModuleList(block(cfg, gen, self.dtype, device)
                                    for _ in range(cfg.n_layers))
        if cfg.encoder_layers:
            #: the encoder's view of the config, the reference's
            self.enc_cfg = dataclasses.replace(cfg, is_encoder=True,
                                               mla=False, n_experts=0,
                                               window=0)
            self.enc_blocks = nn.ModuleList(
                Block(self.enc_cfg, gen, self.dtype, device)
                for _ in range(cfg.encoder_layers))
            self.ln_enc = _gain(cfg, self.dtype, device)

    @property
    def sparse_band(self) -> bool:
        return self.cfg.block_pattern == "sparse-band"

    @property
    def xlstm(self) -> bool:
        return self.cfg.block_pattern == "mlstm7+slstm"

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def _layout(self) -> list:
        """``(tree path, stack index)`` of each parameter, in
        ``parameters()`` order: the keys of its leaf in the reference's
        tree, and its place on the leaf's stacked leading axes (``(i,)``
        for block ``i``, ``(g, j)`` for mLSTM block ``j`` of xLSTM group
        ``g``, ``()`` for an unstacked leaf)."""
        out = []
        for name, _ in self.named_parameters():
            parts = name.split(".")
            keys = (_TREE_NAMES.get(k, k) for k in parts if not k.isdigit())
            out.append((tuple(k for k in keys if k),
                        tuple(int(k) for k in parts if k.isdigit())))
        return out

    def decay_mask(self) -> list:
        """The weight-decay set, one bool a parameter in ``parameters()``
        order: the reference's rule, ``ndim >= 2``, on the rank each
        parameter has in its stacked tree.  A block's parameter is stacked
        on the layer axis there (xLSTM's on one or two group axes), so
        every one is decayed, the norm gains ``ln1`` / ``ln2`` / ``ln_x`` /
        ``ln_m`` / ``ln_s`` too; of the rest ``tok`` and ``frontend_proj``
        are and ``ln_f`` and ``ln_enc`` are not, although the reference's
        comment says "norms/bias exempt" (ROADMAP Queue 3)."""
        return [p.dim() + len(idx) >= 2
                for p, (_, idx) in zip(self.parameters(), self._layout())]

    def from_tree(self, tree) -> list:
        """The leaves of a tree in the reference's layout (``init_params``'s
        keys, each block weight stacked on its leading axes), one a
        parameter in ``parameters()`` order: row ``i`` of a stacked leaf
        for block ``i``.  Raises ``ValueError`` for other keys or another
        layer count.  The inverse of ``to_tree``."""
        layout = self._layout()
        depth = {}
        for path, idx in layout:
            d = depth.setdefault(path, [0] * len(idx))
            depth[path] = [max(n, i + 1) for n, i in zip(d, idx)]
        expected = _nest((path, None) for path in depth)
        if set(tree) != set(expected):
            raise ValueError(f"keys {sorted(tree)}, expected "
                             f"{sorted(expected)}")
        for k, want in expected.items():
            got = _keys(tree[k])
            if got == want:
                continue
            if isinstance(got, dict) and isinstance(want, dict) and \
                    set(got) != set(want) and k in ("layers", "enc_layers"):
                raise ValueError(f"layer keys {sorted(got)}, expected "
                                 f"{sorted(want)}")
            raise ValueError(f"keys {got} for {want}")
        leaves = []
        for path, idx in layout:
            leaf = functools.reduce(operator.getitem, path, tree)
            lead = tuple(leaf.shape[:len(idx)])
            if lead != tuple(depth[path]):
                raise ValueError(f"{'/'.join(path)} stacks {lead} layers for "
                                 f"the model's {tuple(depth[path])}")
            leaves.append(leaf[idx] if idx else leaf)
        return leaves

    def to_tree(self, tensors) -> dict:
        """One tensor a parameter, in ``parameters()`` order, as a tree in
        the reference's layout: the blocks' tensors stacked on their
        leading axes (the AdamW moments take the same form)."""
        stacks = {}
        for (path, idx), t in zip(self._layout(), tensors):
            stacks.setdefault(path, {})[idx] = t
        return _nest((path, _stack(entries))
                     for path, entries in stacks.items())

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
        numpy arrays or tensors; layer weights stacked on their leading
        axes)."""
        for dst, src in zip(self.parameters(), self.from_tree(params)):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} for a parameter "
                                 f"of shape {tuple(dst.shape)}")
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src, np.float32))
            dst.copy_(src)

    def _embed_inputs(self, batch: dict) -> torch.Tensor:
        """The token embeddings, or the projected ``embeds``."""
        if "tokens" in batch:
            return self.tok["embed"][batch["tokens"]]
        return batch["embeds"].to(self.dtype) @ self.frontend_proj

    def _encoder(self, enc_embeds, impl: str, train: bool) -> torch.Tensor:
        """The encoder over the projected ``enc_embeds (B, Se, d)``:
        non-causal blocks (``enc_cfg``), each under ``cfg.remat`` in a
        training forward, then ``ln_enc``."""
        cfg = self.enc_cfg
        x = enc_embeds.to(self.dtype) @ self.frontend_proj
        pos = torch.arange(x.shape[1], device=x.device)

        def run(blk, x):
            return blk(cfg, x, pos, impl=impl, train=train)[0]
        if train:
            run = remat(cfg.remat, run)
        for blk in self.enc_blocks:
            x = run(blk, x)
        return L.rms_norm(self.ln_enc, x, cfg.norm_eps)

    def _cross(self, batch: dict, impl: str, train: bool) -> dict:
        """The decoder blocks' ``enc_out`` keyword: the encoder's output
        for an encoder-decoder, nothing otherwise."""
        if not self.cfg.encoder_layers:
            return {}
        return {"enc_out": self._encoder(batch["enc_embeds"], impl, train)}

    def forward(self, batch, *, impl: str = "cuda", train: bool = False,
                rules=None):
        """batch (a dict of the reference's keys, or tokens ``(B, S)``) →
        logits ``(B, S, V)``; records a graph when grad mode is on, none
        under ``inference_mode``.  ``train=True`` is a training forward:
        ``scan_attention`` in every attention and each block under
        ``cfg.remat``.  ``rules`` on a mesh of more than one entry raises:
        the parameters are placed on a mesh once, by
        ``launch.steps.make_prefill_step(model, rules=rules)`` or a
        ``MeshExecutor``, whose ``forward`` runs there."""
        _refuse_mesh(rules, "make_prefill_step", "forward")
        cfg = self.cfg
        batch = _as_batch(batch)
        x = self._embed_inputs(batch)
        if self.xlstm:
            for grp in self.groups:
                x = grp(cfg, x, train=train)
        else:
            if self.sparse_band:
                a_band = S.decay_band_csr(x.shape[1], cfg.band_window,
                                          cfg.band_decay)

                def run(blk, x):
                    return blk(cfg, x, a_band, impl=impl)
            else:
                pos = torch.arange(x.shape[1], device=x.device)
                cross = self._cross(batch, impl, train)

                def run(blk, x):
                    return blk(cfg, x, pos, impl=impl, train=train,
                               **cross)[0]
            if train:
                run = remat(cfg.remat, run)
            for blk in self.blocks:
                x = run(blk, x)
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return x @ self.tok["lm_head"]

    def _check_decode(self) -> None:
        if self.sparse_band:
            raise NotImplementedError(
                "sparse-band blocks have no decode cache; serve via "
                "forward()")

    def init_cache(self, batch_size: int, max_len: int, *, rules=None):
        """Zeros in the reference's layout of the model's cache family, on
        the model's device (``init_cache``); with ``rules`` on a mesh, a
        ``MeshCache`` laid out by ``cache_shardings``."""
        self._check_decode()
        if on_mesh(rules):
            return MeshCache(self.cfg, batch_size, max_len, rules)
        return init_cache(self.cfg, batch_size, max_len, device=self.device)

    @torch.no_grad()
    def decode_step(self, batch, cache, cache_len: int, *,
                    impl: str = "cuda", rules=None):
        """One decode step (S == 1), or a batched prefill that fills an
        empty cache (S > 1, ``cache_len == 0``); ``batch`` as
        ``forward``'s.  Writes the cache in place; returns ``(logits (B, S,
        V), cache)``.  ``rules`` on a mesh of more than one entry raises, as
        ``forward``'s: ``launch.steps.make_serve_step(model, rules=rules)``
        or a ``MeshExecutor``'s ``decode_step`` runs a step there, on the
        ``MeshCache`` of ``init_cache(..., rules=rules)``."""
        self._check_decode()
        _refuse_mesh(rules, "make_serve_step", "decode_step")
        cfg = self.cfg
        batch = _as_batch(batch)
        x = self._embed_inputs(batch)
        if self.xlstm:
            c, hid = cache["slstm"]
            for i, grp in enumerate(self.groups):
                x = grp(cfg, x, cache=(cache["mlstm"][i], (c[i], hid[i])))
        else:
            pos = cache_len + torch.arange(x.shape[1], device=x.device)
            cross = self._cross(batch, impl, False)
            for i, blk in enumerate(self.blocks):
                layer = cache[i] if cfg.mla else tuple(c[i] for c in cache)
                x, _ = blk(cfg, x, pos, cache=layer, cache_len=cache_len,
                           impl=impl, **cross)
        x = L.rms_norm(self.ln_f, x, cfg.norm_eps)
        return x @ self.tok["lm_head"], cache


# ==================================================================== mesh ==
def on_mesh(rules) -> bool:
    """Whether ``rules`` asks for the mesh executor: a mesh of more than one
    entry (a 1 × 1 mesh runs the one-device path)."""
    return rules is not None and rules.mesh is not None and \
        rules.mesh.devices.size > 1


def _refuse_mesh(rules, step: str, method: str) -> None:
    if on_mesh(rules):
        raise ValueError(
            f"the model's {method} runs on one device; over a mesh, place "
            f"the parameters once with launch.steps.{step}(model, "
            f"rules=rules) or MeshExecutor(model, rules).{method}")


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, sharding.P):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(tree)


def _overlap(a, b):
    """The intersection of two regions (one ``(start, stop)`` a dimension),
    or None."""
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in
                zip(a, b))
    return None if any(x0 >= x1 for x0, x1 in out) else out


def _within(region, outer, drop=0) -> tuple:
    """Index of ``region`` inside a tensor holding ``outer``; the first
    ``drop`` dimensions become ints (they are one wide)."""
    idx = tuple(slice(r0 - o0, r1 - o0) for (r0, r1), (o0, _) in
                zip(region, outer))
    return tuple(s.start for s in idx[:drop]) + idx[drop:]


class MeshCache:
    """A decode cache on a mesh: each leaf of ``init_cache``'s tree laid out
    by ``launch.partitioning.cache_shardings``, each member holding its
    block (``parts[k][(j, m)]``, zeros on its device; nothing aliases).

    ``MeshExecutor`` reads a layer's cache through ``take`` and writes it
    back through ``put``: a member whose block holds what it needs works on
    a view of it in place; one that needs more (a block run whole on heads
    split over ``model``, or rows of a cache whose batch is not its
    dimension 1) works on a copy assembled from the blocks that hold it,
    and ``put`` writes the result into every block that holds a part of
    it, so replicated blocks stay equal.  Copies between members count as
    ``all_gather`` bytes."""

    def __init__(self, cfg, batch_size: int, max_len: int, rules):
        from ..launch.partitioning import cache_shardings
        self.mem = sharding.Members(rules)
        self.batch_size = batch_size
        self.tree = init_cache(cfg, batch_size, max_len, device="meta")
        specs = _flatten(cache_shardings(cfg, self.tree, rules.mesh))
        self.leaves = _flatten(self.tree)
        self.regions, self.parts = [], []
        for leaf, spec in zip(self.leaves, specs):
            regs, parts = {}, {}
            for j, m in self.mem.all():
                reg = sharding.spec_region(leaf.shape, spec,
                                           self.mem.coords[j][m],
                                           self.mem.sizes)
                regs[(j, m)] = reg
                parts[(j, m)] = torch.zeros(
                    [b - a for a, b in reg], dtype=leaf.dtype,
                    device=self.mem.devices[j][m])
            self.regions.append(regs)
            self.parts.append(parts)

    def _take_plan(self, k: int, needs: dict) -> dict:
        """Member -> None where its block holds all it needs (in place),
        else the ``(source, region)`` copies that assemble it, its own
        block first, each region from the first block that holds it."""
        plan = {}
        for who, need in needs.items():
            if _overlap(need, self.regions[k][who]) == tuple(need):
                plan[who] = None
                continue
            copies = []
            for src in [who] + [y for y in self.regions[k] if y != who]:
                ov = _overlap(need, self.regions[k][src])
                if ov is None or any(_overlap(ov, c) == ov
                                     for _, c in copies):
                    continue
                copies.append((src, ov))
            plan[who] = copies
        return plan

    def _put_plan(self, k: int, needs: dict, in_place: dict) -> list:
        """``(source member, destination block, region)`` of every write
        ``put`` makes: each distinct region of ``needs`` (members that need
        one region computed the same values) from a member that wrote it in
        place (else the first) into every block that holds a part of it,
        except the blocks written in place."""
        by_region = {}
        for who, need in needs.items():
            by_region.setdefault(tuple(need), []).append(who)
        writes = []
        for need, group in by_region.items():
            src = next((w for w in group if in_place[w]), group[0])
            for dst, held in self.regions[k].items():
                if dst in group and in_place[dst]:
                    continue
                ov = _overlap(need, held)
                if ov is not None:
                    writes.append((src, dst, ov))
        return writes

    def moved(self, k: int, needs: dict) -> int:
        """The bytes ``take`` and then ``put`` of leaf ``k`` for ``needs``
        count as ``all_gather``, nothing moved: what a block's form costs
        in cache traffic (``MeshExecutor.block_bytes``)."""
        size = self.leaves[k].element_size()

        def nbytes(reg):
            return int(np.prod([b - a for a, b in reg])) * size
        plan = self._take_plan(k, needs)
        total = sum(nbytes(ov) for who, copies in plan.items() if copies
                    for src, ov in copies if src != who)
        writes = self._put_plan(k, needs, {w: c is None
                                           for w, c in plan.items()})
        return total + sum(nbytes(ov) for src, dst, ov in writes
                           if dst != src)

    def take(self, k: int, needs: dict) -> dict:
        """Leaf ``k``'s tensors for ``needs`` (member -> region, the layer
        dimension one wide and dropped): ``(tensor, in place)`` a member."""
        out = {}
        for who, copies in self._take_plan(k, needs).items():
            need, held = needs[who], self.regions[k][who]
            if copies is None:
                out[who] = (self.parts[k][who][_within(need, held, 1)], True)
                continue
            dev = self.mem.devices[who[0]][who[1]]
            with sharding.turn(who):
                t = torch.zeros([b - a for a, b in need[1:]],
                                dtype=self.leaves[k].dtype, device=dev)
                for src, ov in copies:
                    part = self.parts[k][src][
                        _within(ov, self.regions[k][src], 1)]
                    t[_within(ov, need, 1)[1:]] = part.to(dev)
                    if src != who:
                        sharding.count("all_gather",
                                       part.numel() * part.element_size())
            out[who] = (t, False)
        return out

    def put(self, k: int, needs: dict, taken: dict) -> None:
        """After a layer: each distinct region of ``needs`` (members that
        need one region computed the same values) is written into every
        block that holds a part of it, except the blocks a member wrote in
        place."""
        for src, dst, ov in self._put_plan(
                k, needs, {w: t[1] for w, t in taken.items()}):
            need = needs[src]
            part = taken[src][0][_within(ov, need, 1)[1:]]
            with sharding.turn(dst):
                self.parts[k][dst][_within(ov, self.regions[k][dst], 1)] = \
                    part.to(self.parts[k][dst].device)
            if dst != src:
                sharding.count("all_gather",
                               part.numel() * part.element_size())

    def gather(self):
        """The whole cache on the mesh's first device, in ``init_cache``'s
        layout (each element from a block that holds it)."""
        leaves = []
        for k, leaf in enumerate(self.leaves):
            t = torch.zeros(leaf.shape, dtype=leaf.dtype,
                            device=self.mem.first)
            for who, reg in self.regions[k].items():
                t[tuple(slice(a, b) for a, b in reg)] = \
                    self.parts[k][who].to(t.device)
            leaves.append(t)
        return _unflatten(self.tree, leaves)


class MeshExecutor:
    """The LM on ``rules.mesh``, one member at a time in one process: what
    the reference's specs imply where it leaves the layout to GSPMD.

    The parameters are placed once, when the executor is made: member
    ``(j, m)`` (data shard ``j``, model index ``m``) holds each parameter's
    block under ``param_shardings`` (the stacked spec without its leading
    layer axes; whole where the guard replicated it) on its device: a
    slice of the parameter (a view on its own device), through which
    autograd reaches the model's parameters and sums each one's gradient
    over the members, or with ``trainable=True`` a copy of its own, a
    leaf, as ``launch.steps``' ZeRO-1 step trains them (and writes back
    into the model's parameters, ``write_back``).  A call splits
    the batch over the batch axes and keeps the residual stream whole on
    every model member (``act_btd``).

    Every block is computed on the slices its member holds (the split
    form), each product by how its weight is sliced: a column-sliced
    weight gives the member its own output columns, kept where the next op
    works on heads the member owns (its heads: ``shard_heads``), else made
    whole (``_whole_mm``: the weight gathered or its columns gathered as an
    activation, whichever moves fewer bytes); a row-sliced weight gives a
    partial, in f32 for a 16-bit model (``_partial_mm``), summed by one
    ``psum`` over ``model``; a replicated weight is sliced locally.

    - ``attn`` blocks (GQA with the gated FFN or the MoE layer; MLA; the
      encoder's blocks and the decoder's, with cross-attention): member
      ``m`` computes the q heads its column slice of ``wq`` holds
      (``act_bhtd``) and the kv heads they read (from its slices of ``wk``
      / ``wv``, or from the gathered weights where the kv heads do not
      divide the model axis; with a cache that is then replicated, it
      computes them all), runs the attention (the flash kernel in a
      prefill) on them and multiplies by its row slice of ``wo``; one
      ``psum`` ends the attention, one the cross-attention (q, K and V by
      the same heads, K / V from the whole ``enc_out``), one the FFN
      (``w_gate`` / ``w_up`` column-sliced, ``w_down`` row-sliced,
      ``act_btf``) or the MoE layer (``layers.moe_mesh`` on the ``f``
      slices).  MLA takes the latent ``x·W_dkv`` whole (replicated) and
      expands its heads' K / V from its columns of the replicated ``w_uk``
      / ``w_uv``.  Without ``shard_heads`` every member computes all heads
      (``wq`` / ``wk`` / ``wv`` gathered; MLA's q through ``_whole_mm``)
      and its rows of ``wo``;
    - ``attn+mamba``: the attention as above; the mamba half makes
      ``x·W_in`` whole (its columns split x | z unevenly over heads), runs
      the recurrence on the member's heads (all where they do not divide;
      ``w_bc`` / ``w_dt`` replicated), gathers the heads' output as an
      activation where it split them, and multiplies by its columns of
      ``w_out_proj``; those columns, zero elsewhere, join the attention's
      partial in its one ``psum``;
    - ``sparse-band``: each member runs ``tile_fused_matmul`` on its
      columns of ``wv`` (``c_col = inner / n``: the GeMM-SpMM and
      ``spmm_ell`` kernels on its slice), gates them with its columns of
      the replicated ``wz`` and multiplies by its rows of ``w_down``: one
      ``psum``;
    - xLSTM: an mLSTM block makes ``x·W_up`` whole, computes its heads'
      q / k / v from its columns (all heads from ``_whole_mm`` where they
      do not divide; ``w_f`` / ``w_i`` replicated), the recurrence, and
      its rows of ``w_down``: one ``psum``; the sLSTM makes ``x·W_up``
      whole, runs the time loop on every member (``w_rec`` replicated: no
      collective a step) and multiplies its columns of the result by its
      rows of ``w_down``: one ``psum``;
    - the embedding is vocabulary-row-sliced (a masked lookup and a
      ``psum``), the LM head vocabulary-column-sliced, and the logits are
      gathered for the caller on the mesh's first device;
    - decode caches are ``MeshCache``s (``cache_shardings``); a split
      block reads and writes its region in place: its kv heads, its mamba
      heads where the state is split by heads, and its mLSTM heads (the
      replicated state's other copies are then written by ``put``).

    The per-call choice (``split_form``, one rule, no knob): a block of
    any pattern but the plain ``attn`` decoder (always split) runs in the
    gathered form instead, its sliced weights gathered whole onto each
    member and the block run whole on the member's batch shard
    (``_gathered``), in a call where that form moves fewer bytes between
    members.  ``block_bytes`` counts both forms from the call's shapes
    before anything runs: the split form's ``psum``s and gathers (each at
    ``_whole_mm``'s choice) and its cache traffic; the gathered form's
    weights and the cache regions it rebuilds and writes back
    (``MeshCache.moved``).  Only bytes are weighed, not the compute the
    gathered form repeats on every member.  So a decode step splits (a
    few rows against the weights), while a 32k prefill, or the encoder's
    1,500 frames in each decode step, keeps the gathered form.

    Every collective counts its bytes in ``sharding.comm_bytes``."""

    def __init__(self, model, rules, *, trainable: bool = False):
        self.model, self.cfg, self.rules = model, model.cfg, rules
        self.mem = mem = sharding.Members(rules)
        params = list(model.parameters())
        self.names = [n for n, _ in model.named_parameters()]
        self.index = {n: k for k, n in enumerate(self.names)}
        self.layout = model._layout()
        self.meta_tree = model.to_tree(
            torch.empty(p.shape, dtype=p.dtype, device="meta")
            for p in params)
        tree = sharding.param_shardings(self.meta_tree, rules.mesh)
        self.specs, self.mdim = [], []
        for (path, idx), p in zip(self.layout, params):
            spec = tuple(functools.reduce(operator.getitem, path, tree))
            spec = sharding.P(*spec[len(idx):])
            self.specs.append(spec)
            self.mdim.append(spec.index(rules.model_axis)
                             if rules.model_axis in spec else None)
        self.regions, self.pieces = {}, {}
        for who in mem.all():
            dev = mem.devices[who[0]][who[1]]
            regs, row = [], []
            for p, spec in zip(params, self.specs):
                reg = sharding.spec_region(p.shape, spec,
                                           mem.coords[who[0]][who[1]],
                                           mem.sizes)
                t = p[tuple(slice(a, b) for a, b in reg)]
                row.append(t.detach().to(dev, copy=True).requires_grad_()
                           if trainable else sharding._to(t, dev))
                regs.append(reg)
            self.regions[who], self.pieces[who] = regs, row
        #: the plain ``attn`` decoder, split on every call
        self.tp = (model.cfg.block_pattern == "attn" and not model.cfg.mla
                   and not model.cfg.encoder_layers)
        self._plan_heads()

    # ------------------------------------------------------- parameters --
    def on(self, who):
        """Member ``who``'s device made current (its kernel launches), and
        in a dry run its turn (``sharding.turn``)."""
        return sharding.on_member(self.mem.devices[who[0]][who[1]], who)

    def w(self, who, name: str) -> torch.Tensor:
        """Member ``who``'s block of parameter ``name``."""
        return self.pieces[who][self.index[name]]

    def sliced(self, name: str) -> bool:
        """Whether parameter ``name`` is split over ``model`` (on a model
        axis of more than one)."""
        return self.mem.n_model > 1 and self.mdim[self.index[name]] is not None

    def full(self, j: int, name: str) -> list:
        """Parameter ``name`` whole on each model member of data shard
        ``j``: an ``all_gather`` over ``model`` where it is sliced."""
        k = self.index[name]
        parts = [self.pieces[(j, m)][k] for m in range(self.mem.n_model)]
        if self.mdim[k] is None or len(parts) == 1:
            return parts
        return sharding.all_gather(
            parts, self.mem.devices[j], dim=self.mdim[k],
            who=[(j, m) for m in range(self.mem.n_model)])

    def _slice(self, who, name, lo, hi, dim, whole=None):
        """``[lo, hi)`` along ``dim`` of parameter ``name``, from member
        ``who``'s block, or from ``whole`` (the gathered parameter)."""
        k = self.index[name]
        if whole is not None:
            return whole.narrow(dim, lo, hi - lo)
        return self.pieces[who][k].narrow(
            dim, lo - self.regions[who][k][dim][0], hi - lo)

    def _span(self, who, name: str, dim: int) -> tuple:
        """``[lo, hi)`` of parameter ``name`` that member ``who`` holds
        along ``dim``."""
        return self.regions[who][self.index[name]][dim]

    @torch.no_grad()
    def write_back(self) -> None:
        """The members' blocks written into the model's parameters (a
        trained executor's update): each block copied once, from a member
        on the parameter's device where one holds it."""
        for k, t in enumerate(self.model.parameters()):
            done = set()
            whos = sorted(self.mem.all(), key=lambda w: self.mem.devices[
                w[0]][w[1]] != t.device)
            for who in whos:
                reg = self.regions[who][k]
                if reg in done:
                    continue
                t[tuple(slice(a, b) for a, b in reg)] = \
                    self.pieces[who][k].detach().to(t.device)
                done.add(reg)

    def _plan_heads(self) -> None:
        """Each model member's q heads ``[q0, q1)`` (all where
        ``shard_heads`` is off) and the kv heads they read, for the
        attention; the mamba and mLSTM heads split as the q heads do."""
        cfg, n_model = self.cfg, self.mem.n_model
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        rep = h // hkv
        if self.rules.shard_heads and h % n_model:
            raise ValueError(f"shard_heads with {h} heads on a model axis "
                             f"of {n_model}")
        self.split_heads = self.rules.shard_heads and n_model > 1
        gqa = "blocks.0.attn.wk" in self.index
        self.kv_aligned = gqa and self.rules.shard_heads and \
            hkv % n_model == 0
        self.gather_q = gqa and not self.rules.shard_heads and \
            self.mdim[self.index["blocks.0.attn.wq"]] is not None
        self.gather_kv = gqa and not self.kv_aligned and \
            self.mdim[self.index["blocks.0.attn.wk"]] is not None
        self.heads = []
        for m in range(n_model):
            q0, q1 = ((m * h // n_model, (m + 1) * h // n_model)
                      if self.rules.shard_heads else (0, h))
            need = [qh // rep for qh in range(q0, q1)]
            uniq = sorted(set(need))
            g = len(need) // len(uniq)
            grouped = need == [u for u in uniq for _ in range(g)]
            self.heads.append((q0, q1, uniq if grouped else need))

    def _kv_cols(self, m: int, cached: bool) -> tuple:
        """``(c0, c1, kv_sel)``: the kv heads member ``m`` computes, and
        which of them its q heads read (None: all, in order)."""
        hkv = self.cfg.n_kv_heads
        q0, q1, read = self.heads[m]
        if self.kv_aligned:
            n = hkv // self.mem.n_model
            return m * n, (m + 1) * n, None
        c0, c1 = (0, hkv) if cached else (min(read), max(read) + 1)
        sel = [r - c0 for r in read]
        return c0, c1, (None if sel == list(range(c1 - c0)) else sel)

    # ------------------------------------------------------ collectives --
    def _psum_model(self, parts: dict) -> dict:
        out = {}
        for j in range(self.mem.n_data):
            who = [(j, m) for m in range(self.mem.n_model)]
            res = sharding.psum([parts[w] for w in who],
                                self.mem.devices[j], who)
            out.update({(j, m): r for m, r in enumerate(res)})
        return out

    def _module_full(self, prefix: str) -> dict:
        """Member -> the weights of module ``prefix`` gathered whole, keyed
        by their names inside the module."""
        names = [n for n in self.names if n.startswith(prefix + ".")]
        out = {who: {} for who in self.mem.all()}
        for n in names:
            for j in range(self.mem.n_data):
                for m, t in enumerate(self.full(j, n)):
                    out[(j, m)][n[len(prefix) + 1:]] = t
        return out

    def _gather_weight(self, rows: int, s: int, name: str) -> bool:
        """Whether ``_whole_mm`` gathers the column-sliced weight ``name``
        (``(in, out)``) rather than its product's columns for ``rows`` ×
        ``s`` positions: the weight moves no more bytes when ``in <= rows
        · s``."""
        return self.pieces[(0, 0)][self.index[name]].shape[0] <= rows * s

    def _whole_mm(self, name: str, hs: dict) -> dict:
        """Member -> ``h @ W`` whole for the column-sliced weight ``name``
        and each member's ``h`` (equal over ``model``): the weight gathered
        (``full``) or the members' column products gathered as an
        activation, whichever moves fewer bytes."""
        k = self.index[name]
        if not self.sliced(name):
            return self._each(hs, lambda who, h: h @ self.pieces[who][k])
        h0 = next(iter(hs.values()))
        if self._gather_weight(h0.shape[0], h0.shape[1], name):
            out = {}
            for j in range(self.mem.n_data):
                for m, w in enumerate(self.full(j, name)):
                    with self.on((j, m)):
                        out[(j, m)] = hs[(j, m)] @ w
            return out
        cols = self._each(hs, lambda who, h: h @ self.pieces[who][k])
        return self._gather_cols(cols)

    def _gather_cols(self, parts: dict) -> dict:
        """Member -> the members' column blocks of one activation
        concatenated over ``model`` (an ``all_gather`` on the last
        dimension)."""
        out = {}
        for j in range(self.mem.n_data):
            who = [(j, m) for m in range(self.mem.n_model)]
            res = sharding.all_gather([parts[w] for w in who],
                                      self.mem.devices[j], dim=-1, who=who)
            out.update(zip(who, res))
        return out

    # ------------------------------------------------------ the choice --
    def _psum_bytes(self, rows: int, s: int) -> int:
        """What one ``psum`` of a ``_partial_mm`` partial moves in one data
        shard."""
        n, dt = self.mem.n_model, self.model.dtype
        size = 4 if n > 1 and dt in (torch.bfloat16, torch.float16) \
            else dt.itemsize
        return 2 * (n - 1) * rows * s * self.cfg.d_model * size

    def _w_bytes(self, name: str) -> int:
        """What gathering parameter ``name`` moves in one data shard."""
        if not self.sliced(name):
            return 0
        t = self.pieces[(0, 0)][self.index[name]]
        return (self.mem.n_model - 1) * t.numel() * self.mem.n_model * \
            t.element_size()

    def _mm_bytes(self, name: str, rows: int, s: int) -> int:
        """What ``_whole_mm`` moves in one data shard for ``name``."""
        if not self.sliced(name):
            return 0
        if self._gather_weight(rows, s, name):
            return self._w_bytes(name)
        t = self.pieces[(0, 0)][self.index[name]]
        n = self.mem.n_model
        return (n - 1) * rows * s * t.shape[1] * n * t.element_size()

    def block_bytes(self, prefix: str, rows: int, s: int,
                    cache=None) -> tuple:
        """``(split, gathered)``: the bytes each form of the block
        ``prefix`` (``"blocks.0"``, ``"enc_blocks.0"``, ``"groups.0"``)
        moves between members in one call of ``rows`` rows a data shard
        and ``s`` positions, with ``cache`` (a ``MeshCache``) its cache
        traffic too, summed over the mesh."""
        cfg, pre = self.cfg, prefix + "."
        names = [n for n in self.names if n.startswith(pre)]
        gathered = sum(self._w_bytes(n) for n in names)
        psum = self._psum_bytes(rows, s)
        split = 0
        if self.model.xlstm:
            for j7 in range(7):
                mp = f"{pre}mlstm.{j7}."
                split += self._mm_bytes(mp + "w_up", rows, s)
                if not self.split_heads:
                    split += sum(self._mm_bytes(mp + n, rows, s)
                                 for n in ("wq", "wk", "wv"))
                split += psum * self.sliced(mp + "w_down")
            split += self._mm_bytes(pre + "slstm.w_up", rows, s)
            split += psum * self.sliced(pre + "slstm.w_down")
        elif self.model.sparse_band:
            split += psum * (self.sliced(pre + "mix.wv") +
                             self.sliced(pre + "ffn.w_down"))
        else:
            if cfg.mla:
                split += 0 if self.split_heads else \
                    self._mm_bytes(pre + "attn.wq", rows, s)
            else:
                split += self.gather_q * self._w_bytes(pre + "attn.wq")
                split += self.gather_kv * (self._w_bytes(pre + "attn.wk") +
                                           self._w_bytes(pre + "attn.wv"))
            if pre + "mamba.w_in" in self.index:
                split += self._mm_bytes(pre + "mamba.w_in", rows, s)
                if self.split_heads:
                    inner = cfg.n_heads * cfg.ssm_head_dim
                    n = self.mem.n_model
                    split += (n - 1) * rows * s * inner * \
                        self.model.dtype.itemsize
            split += psum * self.sliced(pre + "attn.wo")
            if pre + "xattn.wq" in self.index:
                split += self.gather_q * self._w_bytes(pre + "xattn.wq")
                split += self.gather_kv * (self._w_bytes(pre + "xattn.wk") +
                                           self._w_bytes(pre + "xattn.wv"))
                split += psum * self.sliced(pre + "xattn.wo")
            ffn = pre + ("moe.w2" if cfg.n_experts else "ffn.w_down")
            split += psum * self.sliced(ffn)
        split, gathered = split * self.mem.n_data, gathered * self.mem.n_data
        if cache is not None:
            i = int(prefix.split(".")[1])
            for k in range(len(cache.leaves)):
                split += cache.moved(k, self._needs(cache, k, i, True))
                gathered += cache.moved(k, self._needs(cache, k, i, False))
        return split, gathered

    def split_form(self, prefix: str, rows: int, s: int,
                   cache=None) -> bool:
        """Whether the block ``prefix`` runs split in this call: the rule,
        from ``block_bytes``: split where it moves fewer bytes than the
        gathered form.  The plain ``attn`` decoder always splits."""
        if self.tp:
            return True
        split, gathered = self.block_bytes(prefix, rows, s, cache)
        return split < gathered

    # ----------------------------------------------------------- blocks --
    def _stage(self, fn, x, train: bool, *rest):
        return remat(self.cfg.remat, fn)(x, *rest) if train else \
            fn(x, *rest)

    def _gathered(self, prefix, blk, xs, call, train, wrap=True) -> dict:
        """Block ``blk`` run whole on each member's batch shard with its
        gathered weights: ``call(f, x, who)``, ``f`` the block's forward on
        those weights."""
        full = self._module_full(prefix)
        out = {}
        for who, x in xs.items():
            def f(*args, _w=full[who], **kwargs):
                return torch.func.functional_call(blk, _w, args, kwargs)

            def fn(x, _f=f, _who=who):
                return call(_f, x, _who)
            with self.on(who):
                out[who] = self._stage(fn, x, train and wrap)
        return out

    def _attn_partial(self, who, pre, cfg, x, pos, cache, cache_len, impl,
                      train, whole):
        dh = cfg.head_dim
        pre = pre + "attn."
        q0, q1, _ = self.heads[who[1]]
        c0, c1, kv_sel = self._kv_cols(who[1], cache is not None)
        p = {"wq": self._slice(who, pre + "wq", q0 * dh, q1 * dh, 1,
                               whole.get("wq")),
             "wk": self._slice(who, pre + "wk", c0 * dh, c1 * dh, 1,
                               whole.get("wk")),
             "wv": self._slice(who, pre + "wv", c0 * dh, c1 * dh, 1,
                               whole.get("wv"))}
        if cfg.attn_bias:
            p["bq"] = self._slice(who, pre + "bq", q0 * dh, q1 * dh, 0)
            p["bk"] = self._slice(who, pre + "bk", c0 * dh, c1 * dh, 0)
            p["bv"] = self._slice(who, pre + "bv", c0 * dh, c1 * dh, 0)
        k_o = self.index[pre + "wo"]
        r0, r1 = self.regions[who][k_o][0]
        ln1, wo = self.w(who, pre[:-5] + "ln1"), self.pieces[who][k_o]

        def fn(x):
            b, s, _ = x.shape
            h = L.rms_norm(ln1, x, cfg.norm_eps)
            q, k, v = L.gqa_qkv(p, cfg, h, pos)
            out, _ = L.attend(cfg, q, k, v, cache=cache, cache_len=cache_len,
                              window=cfg.window, impl=impl, train=train,
                              kv_sel=kv_sel)
            out = out.transpose(1, 2).reshape(b, s, -1)
            return self._partial_mm(out[..., r0 - q0 * dh:r1 - q0 * dh], wo)
        return self._stage(fn, x, train)

    def _mla_parts(self, pre, xs, pos, layer, cache_len, impl, train):
        """Member -> its partial of an MLA block's attention: its q heads
        (its columns of ``wq``; all heads through ``_whole_mm`` without
        ``shard_heads``), the latent whole, its heads' K / V from its
        columns of ``w_uk`` / ``w_uv``, and its rows of ``wo``."""
        cfg, dh = self.cfg, self.cfg.head_dim
        pre = pre + "attn."
        hs = self._each(xs, lambda who, x: L.rms_norm(
            self.w(who, pre[:-5] + "ln1"), x, cfg.norm_eps))
        qs = None if self.split_heads else self._whole_mm(pre + "wq", hs)
        out = {}
        for who, h in hs.items():
            q0, q1, _ = self.heads[who[1]]
            p = {n: self._slice(who, pre + n, q0 * dh, q1 * dh, 1)
                 for n in ("w_uk", "w_uv")}
            p["w_dkv"] = self.w(who, pre + "w_dkv")
            if self.split_heads:
                p["wq"] = self._slice(who, pre + "wq", q0 * dh, q1 * dh, 1)
            r0, r1 = self._span(who, pre + "wo", 0)
            wo = self.w(who, pre + "wo")
            cache = layer and layer[who]

            def fn(h, q, _p=p, _wo=wo, _pos=pos[who], _cache=cache, _q0=q0,
                   _r=(r0, r1)):
                a, _ = L.mla_attend(_p, cfg, h, q=q, pos=_pos, cache=_cache,
                                    cache_len=cache_len, impl=impl,
                                    train=train)
                return self._partial_mm(
                    a[..., _r[0] - _q0 * dh:_r[1] - _q0 * dh], _wo)
            with self.on(who):
                out[who] = self._stage(fn, h, train,
                                       None if qs is None else qs[who])
        return out

    def _cross_partial(self, who, pre, cfg, x, enc, impl, train, whole):
        """Member ``who``'s partial of a decoder block's cross-attention:
        q from its heads' columns of ``wq``, K / V from the whole
        ``enc_out`` and its kv heads' columns, its rows of ``wo``."""
        dh = cfg.head_dim
        pre = pre + "xattn."
        q0, q1, _ = self.heads[who[1]]
        c0, c1, kv_sel = self._kv_cols(who[1], False)
        wq = self._slice(who, pre + "wq", q0 * dh, q1 * dh, 1,
                         whole.get("wq"))
        wk = self._slice(who, pre + "wk", c0 * dh, c1 * dh, 1,
                         whole.get("wk"))
        wv = self._slice(who, pre + "wv", c0 * dh, c1 * dh, 1,
                         whole.get("wv"))
        r0, r1 = self._span(who, pre + "wo", 0)
        ln_x, wo = self.w(who, pre[:-6] + "ln_x"), self.w(who, pre + "wo")

        def fn(x, enc):
            h = L.rms_norm(ln_x, x, cfg.norm_eps)
            k, v = enc @ wk, enc @ wv
            if kv_sel is not None:
                b, se, _ = k.shape
                k, v = (t.view(b, se, -1, dh)[:, :, kv_sel].reshape(b, se, -1)
                        for t in (k, v))
            out = L.cross_attend(cfg, h @ wq, k, v, impl=impl, train=train)
            return self._partial_mm(out[..., r0 - q0 * dh:r1 - q0 * dh], wo)
        return self._stage(fn, x, train, enc)

    def _partial_mm(self, a, w):
        """``a @ w``, a member's partial of a row-sliced product: in f32 for
        a 16-bit model on a model axis of more than one, so the ``psum``
        adds f32 partials and the sum rounds once, as one product's f32
        accumulator does."""
        if self.mem.n_model > 1 and a.dtype in (torch.bfloat16,
                                                torch.float16):
            return a.float() @ w.float()
        return a @ w

    def _ffn_partial(self, who, pre, x, train):
        """Member ``who``'s gated FFN output: its partial of the row-sliced
        ``w_down`` (a ``psum`` needed), or the whole output where the guard
        replicated the FFN; returns ``(y, partial)``."""
        cfg = self.cfg
        ln2 = self.w(who, pre + "ln2")
        ffn = {n: self.w(who, pre + "ffn." + n)
               for n in ("w_gate", "w_up", "w_down")}
        sliced = self.mdim[self.index[pre + "ffn.w_down"]] is not None

        def fn(x):
            h = L.rms_norm(ln2, x, cfg.norm_eps)
            if not sliced:
                return L.ffn_apply(ffn, cfg, h)
            h = L._act(cfg)(h @ ffn["w_gate"]) * (h @ ffn["w_up"])
            return self._partial_mm(h, ffn["w_down"])
        return self._stage(fn, x, train), sliced

    def _moe(self, i, xs, train) -> dict:
        """Block ``i``'s MoE layer over all members: ``layers.moe_mesh`` (the
        layer's one mesh path) on each member's ``f`` slices.  Where the
        batch does not divide, every data shard holds all rows
        (``Members.rows``) and the result is the same: the dispatch is per
        row."""
        cfg, pre = self.cfg, f"blocks.{i}."
        if self.mem.n_model > 1 and cfg.d_ff % self.mem.n_model:
            raise ValueError(f"the MoE layer slices d_ff {cfg.d_ff} over a "
                             f"model axis of {self.mem.n_model}")
        pieces = {}
        for who in xs:
            shared = ({n: self.w(who, pre + "moe.shared." + n)
                       for n in ("w_gate", "w_up", "w_down")}
                      if cfg.moe_shared_expert else None)
            pieces[who] = tuple(self.w(who, pre + "moe." + n) for n in
                                ("router", "w1", "w3", "w2")) + (shared,)
        cap = L.moe_capacity(cfg, next(iter(xs.values())).shape[1])

        def run(who, fn, x):
            ln2 = self.w(who, pre + "ln2")
            with self.on(who):
                return self._stage(
                    lambda x: fn(L.rms_norm(ln2, x, cfg.norm_eps)), x, train)
        return L.moe_mesh(cfg, self.mem, xs, pieces, cap, run)

    def _qkv_whole(self, pre: str, xs) -> dict:
        """Member -> the q / k / v weights of attention module ``pre``
        gathered whole where the heads do not divide (``gather_q``,
        ``gather_kv``)."""
        whole = {who: {} for who in xs}
        for n, on in (("wq", self.gather_q), ("wk", self.gather_kv),
                      ("wv", self.gather_kv)):
            if not on:
                continue
            for j in range(self.mem.n_data):
                for m, t in enumerate(self.full(j, pre + n)):
                    whole[(j, m)][n] = t
        return whole

    def _add(self, xs: dict, parts: dict, psum: bool, scale=None) -> dict:
        """``x + parts`` on each member, the parts summed over ``model``
        first where they are partials."""
        if psum:
            parts = self._psum_model(parts)
        if scale is None:
            return self._each(xs, lambda who, x: x + parts[who].to(x.dtype))
        return self._each(xs, lambda who, x: x + (parts[who] * scale).to(
            x.dtype))

    def _ffn(self, pre, i, xs, train) -> dict:
        """The block's FFN (or MoE layer) over all members, added."""
        if self.cfg.n_experts:
            return self._add(xs, self._moe(i, xs, train), False)
        out = {}
        for who, x in xs.items():
            with self.on(who):
                out[who] = self._ffn_partial(who, pre, x, train)
        return self._add(xs, {who: y for who, (y, _) in out.items()},
                         next(iter(out.values()))[1])

    def _tp_block(self, i, xs, pos, layer, cache_len, impl, train, *,
                  prefix="blocks", cfg=None, enc=None):
        """One split ``attn`` block over all members (``prefix`` and
        ``cfg``: an encoder block's), with cross-attention over ``enc``
        (member -> its rows of the encoder's output) in a decoder."""
        cfg = self.cfg if cfg is None else cfg
        pre = f"{prefix}.{i}."
        if cfg.mla:
            parts = self._mla_parts(pre, xs, pos, layer, cache_len, impl,
                                    train)
        else:
            whole = self._qkv_whole(pre + "attn.", xs)
            parts = {}
            for who, x in xs.items():
                with self.on(who):
                    parts[who] = self._attn_partial(
                        who, pre, cfg, x, pos[who], layer and layer[who],
                        cache_len, impl, train, whole[who])
        xs = self._add(xs, parts, self.sliced(pre + "attn.wo"))
        if enc is not None:
            whole = self._qkv_whole(pre + "xattn.", xs)
            parts = {}
            for who, x in xs.items():
                with self.on(who):
                    parts[who] = self._cross_partial(
                        who, pre, cfg, x, enc[who], impl, train, whole[who])
            xs = self._add(xs, parts, self.sliced(pre + "xattn.wo"))
        return self._ffn(pre, i, xs, train)

    def _hybrid_block(self, i, xs, pos, layer, cache_len, impl, train):
        """One split ``attn+mamba`` block: the attention's partial and the
        mamba half's ``w_out_proj`` columns (zero elsewhere) in one
        ``psum``, averaged into ``x``; then the FFN."""
        cfg, pre = self.cfg, f"blocks.{i}."
        mp, dh = pre + "mamba.", cfg.ssm_head_dim
        split = self.sliced(pre + "attn.wo")
        if split != self.sliced(mp + "w_out_proj"):
            raise ValueError("attn+mamba on a mesh needs wo's rows and "
                             "w_out_proj's columns split alike")
        whole = self._qkv_whole(pre + "attn.", xs)
        attn = {}
        for who, x in xs.items():
            with self.on(who):
                attn[who] = self._attn_partial(
                    who, pre, cfg, x, pos[who],
                    layer and layer[who][:2], cache_len, impl, train,
                    whole[who])
        hs = self._each(xs, lambda who, x: L.rms_norm(
            self.w(who, pre + "ln1"), x, cfg.norm_eps))
        xz = self._whole_mm(mp + "w_in", hs)
        inner = cfg.n_heads * dh
        heads = {}
        for who, t in xz.items():
            q0, q1, _ = self.heads[who[1]]
            p = {n: self.w(who, mp + n) for n in ("w_bc", "w_dt", "a_log")}
            cache = layer and layer[who][2]
            sel = (q0, q1) if self.split_heads else None

            def fn(t, _p=p, _sel=sel, _cache=cache, _q=(q0, q1)):
                z = t[..., inner + _q[0] * dh:inner + _q[1] * dh]
                o, state = S.mamba_mix(_p, cfg, t[..., :inner], z,
                                       heads=_sel, cache=_cache)
                if _cache is not None:
                    _cache.copy_(state)
                return o
            with self.on(who):
                heads[who] = self._stage(fn, t, train)
        o = self._gather_cols(heads) if self.split_heads else heads
        parts = {}
        for who, x in xs.items():
            with self.on(who):
                y = o[who] @ self.w(who, mp + "w_out_proj")
                if split:
                    c0, c1 = self._span(who, mp + "w_out_proj", 1)
                    y = F.pad(y, (c0, cfg.d_model - c1))
                parts[who] = attn[who] + y
        xs = self._add(xs, parts, split, 0.5)
        return self._ffn(pre, i, xs, train)

    def _band_block(self, i, xs, a_band, impl, train):
        """One split ``sparse-band`` block: each member's columns of the
        band mixer (the fused GeMM-SpMM at ``c_col = inner / n``), gated
        by its columns of ``wz``, times its rows of ``w_down``; one
        ``psum``; then the FFN."""
        cfg, pre = self.cfg, f"blocks.{i}."
        mp = pre + "mix."
        parts = {}
        for who, x in xs.items():
            c0, c1 = self._span(who, mp + "wv", 1)
            p = {"wv": self.w(who, mp + "wv"),
                 "wz": self._slice(who, mp + "wz", c0, c1, 1)}
            ln1, w_down = self.w(who, pre + "ln1"), self.w(who, mp + "w_down")

            def fn(x, _p=p, _ln1=ln1, _wd=w_down):
                h = L.rms_norm(_ln1, x, cfg.norm_eps)
                return self._partial_mm(
                    S.band_mix_gated(_p, h, a_band, backend=impl), _wd)
            with self.on(who):
                parts[who] = self._stage(fn, x, train)
        xs = self._add(xs, parts, self.sliced(mp + "wv"))
        return self._ffn(pre, i, xs, train)

    def _xlstm_group(self, i, xs, layer, train):
        """One split xLSTM group: 7 mLSTM blocks on the members' heads (or
        all heads) and its rows of ``w_down``, each ending in one ``psum``,
        then the sLSTM's time loop on every member and its rows of
        ``w_down``; the mLSTM blocks under ``cfg.remat`` in training, the
        sLSTM outside it, as in the reference."""
        cfg, pre = self.cfg, f"groups.{i}."
        dh = cfg.ssm_head_dim
        inner = cfg.n_heads * dh
        for j7 in range(7):
            mp = f"{pre}mlstm.{j7}."
            hs = self._each(xs, lambda who, x, _ln=f"{pre}ln_m.{j7}":
                            L.rms_norm(self.w(who, _ln), x, cfg.norm_eps))
            mg = self._whole_mm(mp + "w_up", hs)
            mains = self._each(mg, lambda who, t: t[..., :inner])
            if self.split_heads:
                qkv = {who: tuple(m @ self._slice(
                    who, mp + n, self.heads[who[1]][0] * dh,
                    self.heads[who[1]][1] * dh, 1) for n in ("wq", "wk", "wv"))
                    for who, m in mains.items()}
            else:
                each = [self._whole_mm(mp + n, mains)
                        for n in ("wq", "wk", "wv")]
                qkv = {who: tuple(t[who] for t in each) for who in mains}
            parts = {}
            for who, t in mg.items():
                q0, q1, _ = self.heads[who[1]]
                p = {n: self.w(who, mp + n) for n in ("w_f", "w_i")}
                r0, r1 = self._span(who, mp + "w_down", 0)
                w_down = self.w(who, mp + "w_down")
                cache = layer and layer[who][0][j7]
                sel = (q0, q1) if self.split_heads else None

                def fn(t, q, k, v, _p=p, _sel=sel, _cache=cache,
                       _q=(q0, q1), _r=(r0, r1), _wd=w_down):
                    gate = t[..., inner + _q[0] * dh:inner + _q[1] * dh]
                    o, state = S.mlstm_mix(_p, cfg, t[..., :inner], gate,
                                           qkv=(q, k, v), heads=_sel,
                                           cache=_cache)
                    if _cache is not None:
                        _cache.copy_(state)
                    return self._partial_mm(
                        o[..., _r[0] - _q[0] * dh:_r[1] - _q[0] * dh], _wd)
                with self.on(who):
                    parts[who] = self._stage(fn, t, train, *qkv[who])
            xs = self._add(xs, parts, self.sliced(mp + "w_down"))
        sp = pre + "slstm."
        hs = self._each(xs, lambda who, x: L.rms_norm(
            self.w(who, pre + "ln_s"), x, cfg.norm_eps))
        pre_act = self._whole_mm(sp + "w_up", hs)
        parts = {}
        for who, t in pre_act.items():
            with self.on(who):
                cache = layer and layer[who][1]
                hid, carry = S.slstm_scan({"w_rec": self.w(who, sp + "w_rec")},
                                          cfg, t.float(), cache=cache)
                if cache is not None:
                    for slab, new in zip(cache, carry):
                        slab.copy_(new)
                r0, r1 = self._span(who, sp + "w_down", 0)
                parts[who] = self._partial_mm(
                    hid[..., r0:r1].to(self.model.dtype),
                    self.w(who, sp + "w_down"))
        return self._add(xs, parts, self.sliced(sp + "w_down"))

    # ------------------------------------------------------------ caches --
    def _needs(self, cache, k: int, i: int, split: bool) -> dict:
        """Member -> the region of cache leaf ``k`` layer ``i`` it needs:
        its batch shard's rows (dimension 2 of xLSTM's mLSTM states, 1
        elsewhere); in a split block, the heads it computes (its kv heads,
        its mamba or mLSTM heads)."""
        leaf = cache.leaves[k]
        xlstm = self.model.xlstm
        bdim = 2 if xlstm and k == 0 else 1
        rows = self.mem.rows(cache.batch_size)
        out = {}
        for j, m in self.mem.all():
            need = [(0, n) for n in leaf.shape]
            need[0] = (i, i + 1)
            need[bdim] = (rows[j].start, rows[j].stop)
            if split and not self.cfg.mla:
                q0, q1, _ = self.heads[m]
                if xlstm and k == 0:
                    need[3] = (q0, q1)
                elif not xlstm and k < 2:
                    need[2] = self._kv_cols(m, True)[:2]
                elif k == 2 and not xlstm:
                    need[2] = (q0, q1)
            out[(j, m)] = tuple(need)
        return out

    def _layer_cache(self, parts: list):
        if self.model.xlstm:
            return parts[0], (parts[1], parts[2])
        return parts[0] if self.cfg.mla else tuple(parts)

    # ---------------------------------------------------------- forward --
    def _split(self, batch: dict) -> tuple:
        lead = batch["tokens"] if "tokens" in batch else batch["embeds"]
        b = lead.shape[0]
        rows = self.mem.rows(b)
        inp = {}
        for j, m in self.mem.all():
            with self.on((j, m)):
                inp[(j, m)] = {k: sharding._to(v[rows[j]],
                                               self.mem.devices[j][m])
                               for k, v in batch.items()
                               if isinstance(v, torch.Tensor)}
        return inp, b

    def _embed(self, inp: dict) -> dict:
        k = self.index["tok.embed"]
        parts, sliced = {}, False
        for who, d in inp.items():
            with self.on(who):
                if "tokens" not in d:
                    parts[who] = d["embeds"].to(self.model.dtype) @ \
                        self.w(who, "frontend_proj")
                    continue
                w, tok = self.pieces[who][k], d["tokens"]
                if self.mdim[k] is None:
                    parts[who] = w[tok]
                    continue
                local = tok - self.regions[who][k][0][0]
                hit = (local >= 0) & (local < w.shape[0])
                parts[who] = w[local.clamp(0, w.shape[0] - 1)].masked_fill(
                    ~hit[..., None], 0)
                sliced = True
        return self._psum_model(parts) if sliced else parts

    def _encoder(self, inp, impl, train) -> dict:
        cfg = self.model.enc_cfg
        xs, pos = {}, {}
        for who, d in inp.items():
            with self.on(who):
                xs[who] = d["enc_embeds"].to(self.model.dtype) @ \
                    self.w(who, "frontend_proj")
                pos[who] = torch.arange(xs[who].shape[1],
                                        device=xs[who].device)
        rows, s = next(iter(xs.values())).shape[:2]
        split = self.split_form("enc_blocks.0", rows, s)
        for i, blk in enumerate(self.model.enc_blocks):
            if split:
                xs = self._tp_block(i, xs, pos, None, None, impl, train,
                                    prefix="enc_blocks", cfg=cfg)
                continue
            xs = self._gathered(
                f"enc_blocks.{i}", blk, xs,
                lambda f, x, who: f(cfg, x, pos[who], impl=impl,
                                    train=train)[0], train)
        return self._each(xs, lambda who, x: L.rms_norm(
            self.w(who, "ln_enc"), x, cfg.norm_eps))

    def _each(self, xs: dict, fn) -> dict:
        """``fn(who, x)`` for each member, in its turn."""
        out = {}
        for who, x in xs.items():
            with self.on(who):
                out[who] = fn(who, x)
        return out

    def _members(self, batch, impl, train, cache=None, cache_len=0):
        """Each member's logits (its vocabulary slice, or all where the
        head is replicated) and the batch size."""
        model, cfg = self.model, self.cfg
        inp, b = self._split(_as_batch(batch))
        xs = self._embed(inp)
        rows, s = next(iter(xs.values())).shape[:2]
        pos = self._each(xs, lambda who, x: cache_len + torch.arange(
            s, device=x.device))
        enc = self._encoder(inp, impl, train) if cfg.encoder_layers else None
        if model.sparse_band:
            a_band = S.decay_band_csr(s, cfg.band_window, cfg.band_decay)
        blocks = model.groups if model.xlstm else model.blocks
        prefix = "groups" if model.xlstm else "blocks"
        split = self.split_form(f"{prefix}.0", rows, s, cache=cache)
        for i, blk in enumerate(blocks):
            layer = taken = needs = None
            if cache is not None:
                needs = [self._needs(cache, k, i, split)
                         for k in range(len(cache.leaves))]
                taken = [cache.take(k, n) for k, n in enumerate(needs)]
                layer = {who: self._layer_cache([t[who][0] for t in taken])
                         for who in xs}
            if split:
                xs = self._split_block(i, xs, pos, layer, cache_len, impl,
                                       train, enc,
                                       a_band if model.sparse_band else None)
            elif model.xlstm:
                xs = self._gathered(
                    f"groups.{i}", blk, xs,
                    lambda f, x, who: f(cfg, x, cache=layer and layer[who],
                                        train=train), train, wrap=False)
            elif model.sparse_band:
                xs = self._gathered(
                    f"blocks.{i}", blk, xs,
                    lambda f, x, who: f(cfg, x, a_band, impl=impl), train)
            else:
                xs = self._gathered(
                    f"blocks.{i}", blk, xs,
                    lambda f, x, who: f(
                        cfg, x, pos[who], cache=layer and layer[who],
                        cache_len=cache_len, impl=impl, train=train,
                        **({} if enc is None else {"enc_out": enc[who]}))[0],
                    train)
            if cache is not None:
                for k, n in enumerate(needs):
                    cache.put(k, n, taken[k])
        k = self.index["tok.lm_head"]
        logits = self._each(xs, lambda who, x: L.rms_norm(
            self.w(who, "ln_f"), x, cfg.norm_eps) @ self.pieces[who][k])
        return logits, b

    def _split_block(self, i, xs, pos, layer, cache_len, impl, train, enc,
                     a_band) -> dict:
        """Block (or xLSTM group) ``i`` in the split form."""
        if self.model.xlstm:
            return self._xlstm_group(i, xs, layer, train)
        if self.model.sparse_band:
            return self._band_block(i, xs, a_band, impl, train)
        if self.cfg.block_pattern == "attn+mamba":
            return self._hybrid_block(i, xs, pos, layer, cache_len, impl,
                                      train)
        return self._tp_block(i, xs, pos, layer, cache_len, impl, train,
                              enc=enc)

    def logits_by_shard(self, logits: dict) -> list:
        """Each data shard's logits, gathered over ``model`` onto its first
        member's device."""
        out = []
        for j in range(self.mem.n_data):
            parts = [logits[(j, m)] for m in range(self.mem.n_model)]
            if self.mdim[self.index["tok.lm_head"]] is None:
                out.append(parts[0])
            else:
                with self.on((j, 0)):
                    out.append(torch.cat(sharding.gather(
                        parts, self.mem.devices[j][0], (j, 0)), dim=-1))
        return out

    def _global(self, logits: dict, b: int) -> torch.Tensor:
        per_j = self.logits_by_shard(logits)
        with self.on((0, 0)):
            if b % self.mem.n_data:
                return sharding._to(per_j[0], self.mem.first)
            return torch.cat(sharding.gather(per_j, self.mem.first,
                                             (0, 0)))

    def forward(self, batch, *, impl: str = "cuda", train: bool = False):
        """``Transformer.forward`` over the mesh: the whole logits on the
        mesh's first device."""
        return self._global(*self._members(batch, impl, train))

    def member_logits(self, batch, *, impl: str = "cuda") -> dict:
        """Member -> its block of the logits (its vocabulary slice of its
        batch shard, or all of the vocabulary where the head is
        replicated), nothing gathered."""
        return self._members(batch, impl, False)[0]

    def shard_logits(self, batch, *, impl: str = "cuda",
                     train: bool = False) -> list:
        """Each data shard's logits (``logits_by_shard``); a training step
        takes its loss from them."""
        return self.logits_by_shard(self._members(batch, impl, train)[0])

    @torch.no_grad()
    def decode_step(self, batch, cache: MeshCache, cache_len: int, *,
                    impl: str = "cuda"):
        """``Transformer.decode_step`` over the mesh, on a ``MeshCache``."""
        self.model._check_decode()
        if not isinstance(cache, MeshCache):
            raise TypeError("a decode step on a mesh takes the MeshCache of "
                            "init_cache(..., rules=rules)")
        logits, b = self._members(batch, impl, False, cache, cache_len)
        return self._global(logits, b), cache
