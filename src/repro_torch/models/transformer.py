"""Decoder-only LM of the ``attn`` block pattern: self-attention (GQA) and a
gated FFN per block, pre-norm, as in ``repro.models.transformer``.

The reference stacks its layers on a leading scan axis of one pytree; here
the blocks are an ``nn.ModuleList`` and the layers run in a Python loop.
``params_from_jax`` loads the reference's stacked tree, so both packages
can compute the same model.  The KV cache keeps the reference's layout,
``(k, v)`` each ``(L, B, Hkv, C, dh)``, and ``decode_step`` writes into it
in place.

Other block patterns, the encoder, MoE and MLA raise
``NotImplementedError``: later slices bring them (ROADMAP Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import layers as L


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    missing = [what for what, off in [
        (f"block pattern {cfg.block_pattern!r}", cfg.block_pattern == "attn"),
        ("an encoder", not cfg.encoder_layers),
        ("MoE experts", not cfg.n_experts),
        ("MLA", not cfg.mla),
        (f"a {cfg.frontend} frontend", cfg.frontend == "none"),
    ] if not off]
    if missing:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(missing)}, which the port does not "
            f"have yet (ROADMAP Queue 1, the LM stack)")


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in d.items()})


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + ffn(norm(x))``."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        ones = dict(dtype=dtype, device=device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, **ones),
                                requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, **ones),
                                requires_grad=False)
        self.attn = _params(L.gqa_init(gen, cfg, dtype, device))
        self.ffn = _params(L.ffn_init(gen, cfg, dtype, device))

    def forward(self, cfg, x, pos, cache=None, cache_len=None,
                impl="cuda"):
        h = L.rms_norm(self.ln1, x, cfg.norm_eps)
        a, new_cache = L.gqa_attention(self.attn, cfg, h, pos=pos,
                                       cache=cache, cache_len=cache_len,
                                       window=cfg.window, impl=impl)
        x = x + a
        h = L.rms_norm(self.ln2, x, cfg.norm_eps)
        return x + L.ffn_apply(self.ffn, cfg, h), new_cache


class Transformer(nn.Module):
    """The LM.  ``device=None`` means ``"cuda"``, and building the model
    raises when there is no card: it never drops to the CPU on its own
    (pass ``device="cpu"`` for that).  Weights are drawn on the model's
    device from a ``torch.Generator`` seeded with ``seed`` (the reference's
    distributions, not its numbers); ``params_from_jax`` loads the
    reference's weights instead.  ``impl="torch"`` runs prefill attention
    through the plain version of the flash kernel, on any device."""

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
        self.ln_f = nn.Parameter(
            torch.ones(cfg.d_model, dtype=self.dtype, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, gen, self.dtype, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    @torch.no_grad()
    def params_from_jax(self, params) -> None:
        """Copy the reference's ``init_params(cfg, key)`` tree (arrays or
        numpy arrays; layer weights stacked on a leading layer axis)."""
        def load(dst, src):
            src = np.array(src, np.float32)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {src.shape} for a parameter of "
                                 f"shape {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src))

        def load_dict(dst: nn.ParameterDict, src: dict, index=None):
            if set(dst) != set(src):
                raise ValueError(f"keys {sorted(src)} for {sorted(dst)}")
            for name, p in dst.items():
                load(p, src[name] if index is None else src[name][index])

        expected = {"tok", "ln_f", "layers"}
        if set(params) != expected:
            raise ValueError(f"keys {sorted(params)}, expected "
                             f"{sorted(expected)}")
        load_dict(self.tok, params["tok"])
        load(self.ln_f, params["ln_f"])
        layers = params["layers"]
        if set(layers) != {"ln1", "ln2", "attn", "ffn"}:
            raise ValueError(f"layer keys {sorted(layers)}")
        n = np.shape(layers["ln1"])[0]
        if n != len(self.blocks):
            raise ValueError(f"{n} layers for {len(self.blocks)} blocks")
        for i, blk in enumerate(self.blocks):
            load(blk.ln1, layers["ln1"][i])
            load(blk.ln2, layers["ln2"][i])
            load_dict(blk.attn, layers["attn"], i)
            load_dict(blk.ffn, layers["ffn"], i)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, impl: str = "cuda"):
        """tokens ``(B, S)`` → logits ``(B, S, V)``."""
        x = self.tok["embed"][tokens]
        pos = torch.arange(x.shape[1], device=x.device)
        for blk in self.blocks:
            x, _ = blk(self.cfg, x, pos, impl=impl)
        x = L.rms_norm(self.ln_f, x, self.cfg.norm_eps)
        return x @ self.tok["lm_head"]

    def init_cache(self, batch_size: int, max_len: int):
        """``(k, v)``, each ``(L, B, Hkv, C, dh)`` zeros; ``C`` is
        ``max_len``, or the window for a sliding-window model."""
        cfg = self.cfg
        c = min(max_len, cfg.window) if cfg.window > 0 else max_len
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, c, cfg.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache, cache_len: int, *,
                    impl: str = "cuda"):
        """One decode step (S == 1), or a batched prefill that fills an
        empty cache (S > 1, ``cache_len == 0``).  Writes the cache in place;
        returns ``(logits (B, S, V), cache)``."""
        x = self.tok["embed"][tokens]
        s = x.shape[1]
        pos = cache_len + torch.arange(s, device=x.device)
        k_cache, v_cache = cache
        for i, blk in enumerate(self.blocks):
            x, _ = blk(self.cfg, x, pos, cache=(k_cache[i], v_cache[i]),
                       cache_len=cache_len, impl=impl)
        x = L.rms_norm(self.ln_f, x, self.cfg.norm_eps)
        return x @ self.tok["lm_head"], cache
