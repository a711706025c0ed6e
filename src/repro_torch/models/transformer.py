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
"""
from __future__ import annotations

import dataclasses
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

    def forward(self, batch, *, impl: str = "cuda", train: bool = False):
        """batch (a dict of the reference's keys, or tokens ``(B, S)``) →
        logits ``(B, S, V)``; records a graph when grad mode is on, none
        under ``inference_mode``.  ``train=True`` is a training forward:
        ``scan_attention`` in every attention and each block under
        ``cfg.remat``."""
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

    def init_cache(self, batch_size: int, max_len: int):
        """Zeros in the reference's layout of the model's cache family:
        ``(k, v)``, each ``(L, B, Hkv, C, dh)`` (``C`` is ``max_len``, or
        the window for a sliding-window model); for MLA the latent ``(L, B,
        max_len, r)``; for ``attn+mamba`` ``(k, v, state)`` with the mamba
        state ``(L, B, H, n, dh)`` in f32; for xLSTM ``{"mlstm": (g, 7, B,
        H, dh, dh + 1), "slstm": (c, hid)}``, the sLSTM's ``(g, B,
        inner)``, all f32, whatever ``max_len``."""
        cfg = self.cfg
        self._check_decode()

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if self.xlstm:
            g, h, dh = cfg.n_layers // 8, cfg.n_heads, cfg.ssm_head_dim
            f32 = torch.float32
            return {"mlstm": zeros(g, 7, batch_size, h, dh, dh + 1,
                                   dtype=f32),
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

    @torch.no_grad()
    def decode_step(self, batch, cache, cache_len: int, *,
                    impl: str = "cuda"):
        """One decode step (S == 1), or a batched prefill that fills an
        empty cache (S > 1, ``cache_len == 0``); ``batch`` as
        ``forward``'s.  Writes the cache in place; returns ``(logits (B, S,
        V), cache)``."""
        self._check_decode()
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
