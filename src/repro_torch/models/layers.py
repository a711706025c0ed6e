"""Shared LM layers: RMS norm, RoPE, GQA attention, multi-head latent
attention (MLA), cross-attention, the gated FFN, the gated top-k MoE layer
and the embeddings.

Twins of ``repro.models.layers`` in its functional style: parameters are
dicts of tensors (an ``nn.ParameterDict`` works as one) and every layer is
``fn(params, ..., x) -> y``.  Layouts are the reference's: attention
tensors are ``(B, H, S, D)`` and weights are ``(in, out)``.  Prefill
attention (``chunked_attention``) runs the hand-written flash kernel on the
card and its plain version on the CPU.  Training attention
(``scan_attention``) is the reference's own ``chunked_attention`` body, the
XLA function its training step differentiates, in plain PyTorch: the
reference never trains through its Pallas flash kernel, and the port's
flash kernel has no backward.  Everything else is plain PyTorch (products
outside any Pallas kernel were left to XLA by the reference): the MoE
layer's expert products too, which the reference computes in XLA, not in
its (ungated) MoE kernel.

``moe_apply`` takes the reference's mesh path under ``rules`` (the twin of
its ``shard_map``, ``moe_mesh``): each data shard's rows dispatch locally,
the experts are sliced on ``f`` over the model axis, and one ``psum`` sums
the expert and shared-expert partials.  The mesh executor of
``models.transformer`` runs its MoE layers through the same ``moe_mesh``,
and its other layers through the pieces below (``gqa_qkv``, ``attend``)
on each member's slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import NEG_INF


def init_weight(gen: torch.Generator, shape, scale=None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default
    ``1/sqrt(shape[0])``), drawn in f32 and cast: the distribution of the
    reference's ``_init``, not its numbers (the generators differ).
    ``gen=None`` draws nothing: the shape on the meta device."""
    if scale is None:
        scale = 1.0 / shape[0] ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if gen is None:
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------- norms ----
def rms_norm(g, x, eps=1e-5):
    """Statistics in f32; the normalized ``x`` is cast to its dtype before
    the gain multiply, as the reference does."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * g


# ----------------------------------------------------------------- rope ----
def apply_rope(x, pos):
    """x ``(..., S, D)``; pos ``(S,)`` or ``(B, S)`` int positions.  Rotates
    interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` with θ = 10000, as
    the reference does (not the rotate-half form)."""
    d = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = pos[..., :, None].float() * inv          # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    # broadcast over the head axis: x (..., H, S, D) vs angles (..., S, D/2)
    if x.dim() == cos.dim() + 2:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ------------------------------------------------------- chunked attention ----
def chunked_attention(q, k, v, *, causal=True, window=0, impl="cuda"):
    """Prefill attention.  q ``(B, H, Sq, D)``; k, v ``(B, Hkv, Sk, D)``
    with ``H % Hkv == 0``.

    The reference's ``chunked_attention`` is the XLA twin of its flash
    kernel: it repeats k/v to H heads and runs the same online softmax with
    the same masks.  Here the flash kernel itself runs (its plain version
    for CPU tensors or ``impl="torch"``), and k/v are not repeated: the
    kernel reads K/V head ``h // (H // Hkv)`` for query head ``h`` in
    place."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               impl=impl)


def scan_attention(q, k, v, *, causal=True, window=0, chunk=1024,
                   q_offset=0):
    """Training attention: the twin of the reference's ``chunked_attention``
    (``repro.models.layers``), step for step, differentiated by autograd.

    q ``(B, H, Sq, D)``; k, v ``(B, Hkv, Sk, D)`` with ``H % Hkv == 0``;
    ``q_offset`` is the absolute position of ``q[:, :, 0]``.  k and v are
    padded to whole ``chunk``s (the padding masked), each chunk is repeated
    to H heads (``repeat_interleave``, as ``jnp.repeat``), and the online
    softmax runs in f32 over the chunks with the reference's masks at
    ``-1e30``; the output is cast back to q's dtype."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / d ** 0.5
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    q32 = q.float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        cols = slice(ci * chunk, (ci + 1) * chunk)
        kb = k[:, :, cols].repeat_interleave(rep, dim=1).float()
        vb = v[:, :, cols].repeat_interleave(rep, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kb) * scale
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = k_pos[None, :] < sk                     # padding
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


# ---------------------------------------------------------- GQA attention ----
def gqa_init(gen, cfg, dtype, device=None) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_weight(gen, (d, h * dh), dtype=dtype, device=device),
        "wk": init_weight(gen, (d, hkv * dh), dtype=dtype, device=device),
        "wv": init_weight(gen, (d, hkv * dh), dtype=dtype, device=device),
        "wo": init_weight(gen, (h * dh, d), dtype=dtype, device=device),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros(h * dh, dtype=dtype, device=device)
        p["bk"] = torch.zeros(hkv * dh, dtype=dtype, device=device)
        p["bv"] = torch.zeros(hkv * dh, dtype=dtype, device=device)
    return p


def gqa_qkv(p, cfg, x, pos):
    """q ``(B, H, S, dh)`` and k, v ``(B, Hkv, S, dh)``, RoPE applied; the
    head counts are the weights' columns over ``dh``, so a mesh member's
    column slices give its heads."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, -1, dh).transpose(1, 2)
    k = k.reshape(b, s, -1, dh).transpose(1, 2)
    v = v.reshape(b, s, -1, dh).transpose(1, 2)
    if cfg.rope != "none":
        q = apply_rope(q, pos)
        k = apply_rope(k, pos)
    return q, k, v


def decode_attention(q, k_cache, v_cache, n_valid):
    """Single-token attention over a (possibly ring-buffer) KV cache.

    q ``(B, H, 1, dh)``; caches ``(B, Hkv, C, dh)``; ``n_valid`` valid
    slots.  Plain PyTorch, as the reference's is plain XLA: RoPE was applied
    before caching, so only validity masking matters."""
    h, dh = q.shape[1], q.shape[3]
    hkv, c = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    kf = k_cache.repeat_interleave(rep, dim=1).float()
    vf = v_cache.repeat_interleave(rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / dh ** 0.5
    valid = torch.arange(c, device=q.device) < n_valid
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def _write_slots(cache, new, start: int, axis: int = 2) -> None:
    """``new`` written into ``cache`` at ``start`` along ``axis`` (the KV
    slabs' slot axis 2, the MLA latent's 1) in place, with the start
    clamped into range as ``jax.lax.dynamic_update_slice_in_dim`` clamps
    it."""
    s, c = new.shape[axis], cache.shape[axis]
    start = max(0, min(start, c - s))
    cache.narrow(axis, start, s).copy_(new)


def gqa_attention(p, cfg, x, *, pos, cache=None, cache_len=None,
                  window: int = 0, impl: str = "cuda", train: bool = False):
    """Self-attention.  With ``cache=(k_cache, v_cache)`` (this layer's
    ``(B, Hkv, C, dh)`` slabs) it runs a batched prefill from an empty cache
    (S > 1, ``cache_len == 0``) or one decode step (S == 1) and writes the
    new keys and values into the slabs in place (the reference returns new
    arrays); returns ``(out, cache)``.  When ``window > 0`` the cache is a
    ring buffer of ``window`` slots.  ``train=True`` (a training forward,
    no cache) takes ``scan_attention`` on any device and ignores ``impl``;
    otherwise the attention is ``chunked_attention``, whose flash kernel
    refuses grad on the card."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, pos)
    out, new_cache = attend(cfg, q, k, v, cache=cache, cache_len=cache_len,
                            window=window, impl=impl, train=train)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"], new_cache


def attend(cfg, q, k, v, *, cache=None, cache_len=None, window: int = 0,
           impl: str = "cuda", train: bool = False, kv_sel=None):
    """``gqa_attention``'s attention on projected heads: returns ``(out (B,
    H, S, dh), cache)``, writing k and v into the cache slabs as it
    describes.  ``kv_sel`` (a list of head indices of k, v and the slabs)
    picks the kv heads q attends, in order, where a mesh member computes
    more kv heads than its q heads read (a replicated cache); default
    all."""
    s = q.shape[2]

    def sel(t):
        return t if kv_sel is None else t[:, kv_sel]
    if train:
        if cache is not None:
            raise ValueError("a training forward takes no KV cache")
        return scan_attention(q, sel(k), sel(v), causal=not cfg.is_encoder,
                              window=window), None
    if cache is None:
        return chunked_attention(q, sel(k), sel(v),
                                 causal=not cfg.is_encoder, window=window,
                                 impl=impl), None
    k_cache, v_cache = cache
    c = k_cache.shape[2]
    if s > 1:
        out = chunked_attention(q, sel(k), sel(v), causal=True,
                                window=window, impl=impl)
        if s >= c:
            # ring buffer: key at absolute position p lands at slot
            # p % c, a roll of the last c keys
            k_cache.copy_(torch.roll(k[:, :, -c:], s % c, dims=2))
            v_cache.copy_(torch.roll(v[:, :, -c:], s % c, dims=2))
        else:
            _write_slots(k_cache, k, cache_len)
            _write_slots(v_cache, v, cache_len)
    else:
        slot = cache_len % c if window > 0 else cache_len
        _write_slots(k_cache, k, slot)
        _write_slots(v_cache, v, slot)
        out = decode_attention(q, sel(k_cache), sel(v_cache),
                               min(cache_len + 1, c))
    return out, (k_cache, v_cache)


# ------------------------------------------------------------------- MLA ----
def mla_init(gen, cfg, dtype, device=None) -> dict:
    """The query and output projections ``wq (d, h·dh)``, ``wo (h·dh,
    d)``, the latent down-projection ``w_dkv (d, r)`` and the latent's
    K and V up-projections ``w_uk``, ``w_uv (r, h·dh)``."""
    d, h, dh, r = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.mla_kv_rank
    return {
        "wq": init_weight(gen, (d, h * dh), dtype=dtype, device=device),
        "w_dkv": init_weight(gen, (d, r), dtype=dtype, device=device),
        "w_uk": init_weight(gen, (r, h * dh), dtype=dtype, device=device),
        "w_uv": init_weight(gen, (r, h * dh), dtype=dtype, device=device),
        "wo": init_weight(gen, (h * dh, d), dtype=dtype, device=device),
    }


def _mla_expand(p, cfg, lat, pos):
    """The latent ``(B, S, r)`` expanded to K and V ``(B, h, S, dh)``, RoPE
    applied to K at ``pos``; ``h`` is the heads ``w_uk`` / ``w_uv`` hold
    (their columns over ``dh``: a mesh member's slice gives its heads)."""
    b, s, _ = lat.shape
    dh = cfg.head_dim
    k = (lat @ p["w_uk"]).reshape(b, s, -1, dh).transpose(1, 2)
    v = (lat @ p["w_uv"]).reshape(b, s, -1, dh).transpose(1, 2)
    if cfg.rope != "none":
        k = apply_rope(k, pos)
    return k, v


def mla_attention(p, cfg, x, *, pos, cache=None, cache_len=None,
                  impl: str = "cuda", train: bool = False):
    """Multi-head latent attention, the reference's ``mla_attention`` step
    for step: the cache holds the rank-``r`` latent ``x·W_dkv``, and K and
    V are re-expanded from it at every use (``h`` heads each, so the
    attention is multi-head).

    With ``cache`` (this layer's latent slab ``(B, max_len, r)``) the
    fresh latent is written into it at ``cache_len`` in place.  A prefill
    (S > 1) attends over its own expanded latent through
    ``chunked_attention`` (the flash kernel on the card); a decode step
    (S == 1) re-expands the whole cache, RoPE at ``arange(max_len)``, and
    masks all but the first ``min(cache_len + 1, max_len)`` slots in
    ``decode_attention``.  ``train=True`` (no cache) takes
    ``scan_attention``.  Returns ``(out, cache)``."""
    out, cache = mla_attend(p, cfg, x, pos=pos, cache=cache,
                            cache_len=cache_len, impl=impl, train=train)
    return out @ p["wo"], cache


def mla_attend(p, cfg, x, *, q=None, pos, cache=None, cache_len=None,
               impl: str = "cuda", train: bool = False):
    """``mla_attention`` before ``wo``, on the heads ``p`` holds: ``q (B,
    S, h·dh)`` is ``x·W_q`` (``p["wq"]``'s columns of ``h`` heads, or
    given), the latent ``x·W_dkv``, and K / V from ``w_uk`` / ``w_uv``'s
    columns of the same heads.  Returns ``(out (B, S, h·dh), cache)``; the
    latent cache is written as ``mla_attention`` describes.  A mesh member
    runs it on its heads."""
    if q is None:
        q = x @ p["wq"]
    lat = x @ p["w_dkv"]                                   # (B, S, r)
    b, s, _ = q.shape
    dh = cfg.head_dim
    q = q.reshape(b, s, -1, dh).transpose(1, 2)
    if cfg.rope != "none":
        q = apply_rope(q, pos)
    if train:
        if cache is not None:
            raise ValueError("a training forward takes no latent cache")
        k, v = _mla_expand(p, cfg, lat, pos)
        out = scan_attention(q, k, v, causal=True)
    elif cache is not None and s == 1:
        _write_slots(cache, lat, cache_len, axis=1)
        sk = cache.shape[1]
        k, v = _mla_expand(p, cfg, cache, torch.arange(sk, device=q.device))
        out = decode_attention(q, k, v, min(cache_len + 1, sk))
    else:
        if cache is not None:
            _write_slots(cache, lat, cache_len, axis=1)
        k, v = _mla_expand(p, cfg, lat, pos)
        out = chunked_attention(q, k, v, causal=True, impl=impl)
    return out.transpose(1, 2).reshape(b, s, -1), cache


# ------------------------------------------------------- cross-attention ----
def cross_attention(p, cfg, x, enc_out, *, impl: str = "cuda",
                    train: bool = False):
    """Attention of ``x (B, S, d)`` over the encoder's output ``enc_out
    (B, Se, d)``: q from ``x``, k and v from ``enc_out`` (a ``gqa_init``
    dict; no bias, no RoPE, no mask).  Serving runs ``chunked_attention``
    (the flash kernel on the card) at any S, a decode step's S = 1 too, as
    the reference runs its ``chunked_attention``; ``train=True`` runs
    ``scan_attention``.  Returns the output ``(B, S, d)``."""
    return cross_attend(cfg, x @ p["wq"], enc_out @ p["wk"],
                        enc_out @ p["wv"], impl=impl, train=train) @ p["wo"]


def cross_attend(cfg, q, k, v, *, impl: str = "cuda", train: bool = False):
    """``cross_attention`` between its input products and ``wo``: ``q (B,
    S, h·dh)``, ``k``, ``v (B, Se, hkv·dh)``, each the columns of the heads
    computed (a mesh member's).  Returns ``(B, S, h·dh)``."""
    b, s, _ = q.shape
    se, dh = k.shape[1], cfg.head_dim
    q = q.reshape(b, s, -1, dh).transpose(1, 2)
    k = k.reshape(b, se, -1, dh).transpose(1, 2)
    v = v.reshape(b, se, -1, dh).transpose(1, 2)
    if train:
        out = scan_attention(q, k, v, causal=False)
    else:
        out = chunked_attention(q, k, v, causal=False, impl=impl)
    return out.transpose(1, 2).reshape(b, s, -1)


# ------------------------------------------------------------------- FFN ----
def ffn_init(gen, cfg, dtype, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": init_weight(gen, (d, f), dtype=dtype, device=device),
        "w_up": init_weight(gen, (d, f), dtype=dtype, device=device),
        "w_down": init_weight(gen, (f, d), dtype=dtype, device=device),
    }


def _act(cfg):
    if cfg.act == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")   # jax.nn.gelu's default


def ffn_apply(p, cfg, x):
    """Gated FFN (SwiGLU / GeGLU): three plain products.  The fused FFN
    kernel is ungated, so this layer cannot use it (nor does the
    reference's)."""
    h = _act(cfg)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ------------------------------------------------------------------- MoE ----
def moe_init(gen, cfg, dtype, device=None) -> dict:
    """The router ``(d, e)`` in f32 whatever ``dtype``, at scale 0.02; the
    experts' gate, up and down projections ``w1``, ``w3 (e, d, f)`` and
    ``w2 (e, f, d)`` at ``init_weight``'s default scale, ``1/sqrt(e)`` on
    these stacked shapes, as the reference draws them; and ``shared``, an
    ``ffn_init`` dict, when ``cfg.moe_shared_expert`` is set."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": init_weight(gen, (d, e), scale=0.02, device=device),
        "w1": init_weight(gen, (e, d, f), dtype=dtype, device=device),
        "w3": init_weight(gen, (e, d, f), dtype=dtype, device=device),
        "w2": init_weight(gen, (e, f, d), dtype=dtype, device=device),
    }
    if cfg.moe_shared_expert:
        p["shared"] = ffn_init(gen, cfg, dtype, device)
    return p


def moe_capacity(cfg, s: int, capacity_factor: float = 1.25) -> int:
    """Slots an expert has in one batch row of ``s`` tokens: ``capacity_factor
    · s · k / e``, rounded up to a multiple of 8, at least 8."""
    cap = int(capacity_factor * s * cfg.moe_top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


class Dispatch(NamedTuple):
    """The routing of a batch of rows, as the combine and the backward use
    it: each token's experts in ascending order and their gates (f32), and
    the two index tables between ``(token, pick)`` and the slots of
    ``xe``, which are laid out expert by expert, then row by row (``xe (e,
    B·cap, d)``).  A pick is dropped where its ``tok_slot`` is past the
    last slot."""
    experts: torch.Tensor    # (B, s, k) ascending
    gates: torch.Tensor      # (B, s, k) f32, renormalized
    tok_slot: torch.Tensor   # (B·s·k,) row of xe, e·B·cap where dropped
    slot_pick: torch.Tensor  # (e·B·cap,) (token, pick), B·s·k where empty


def _gather_sum(src, idx):
    """``out[i] = Σ_r src[idx[i, r]]``, index ``len(src)`` reading zeros;
    ``r`` is summed in index order."""
    n = src.shape[0]
    out = src.index_select(0, idx.reshape(-1).clamp(max=n - 1))
    out = out.view(*idx.shape, src.shape[1])
    out.masked_fill_((idx == n)[..., None], 0)
    return out.sum(1) if idx.shape[1] > 1 else out[:, 0]


class _GatherRows(torch.autograd.Function):
    """``_gather_sum(src, idx)`` whose backward is ``_gather_sum`` on the
    transposed table ``idx_t`` (for each row of ``src``, the rows of the
    output that read it).  Dispatch and combine move rows both ways
    without a scatter, so no float atomics: the layer and its gradients
    give the same bits twice on the card."""

    @staticmethod
    def forward(ctx, src, idx, idx_t):
        ctx.save_for_backward(idx, idx_t)
        return _gather_sum(src, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, idx_t = ctx.saved_tensors
        return _GatherRows.apply(grad.contiguous(), idx_t, idx), None, None


def _route(cfg, x, router):
    """Each token's top-k gates (renormalized by ``clip(sum, 1e-9)``) and
    experts: f32 router logits, softmax, top-k."""
    gates = torch.softmax(x.float() @ router, dim=-1)          # (B, s, e)
    top_g, top_e = torch.topk(gates, cfg.moe_top_k, dim=-1)
    return top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def _row_dispatch(cfg, x, router, cap):
    """Capacity dispatch of every batch row at once: ``x (B, s, d)`` →
    ``(xe (e, B·cap, d), Dispatch)``.

    The reference's ``_row_dispatch`` under ``vmap``, step for step: f32
    router logits, softmax, top-k, the gates renormalized by ``clip(sum,
    1e-9)``; the row's assignments sorted by expert (a stable sort, so
    tokens stay ascending within an expert and the capacity drops the last
    ones), each one's position by ``searchsorted``.  The rows are batched
    by giving each its own block of ``cap`` slots under every expert; every
    index stays inside its row."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = x.device
    top_g, top_e = _route(cfg, x, router)
    # a token's picks in ascending expert order: the order of the
    # reference's sorted assignments, and of its combine's updates
    experts, perm = top_e.sort(dim=-1)
    gates = top_g.gather(-1, perm)
    flat_e = experts.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    first = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(b, e).contiguous())
    pos = torch.arange(s * k, device=dev) - first.gather(-1, se)
    keep = pos < cap
    rows = torch.arange(b, device=dev)[:, None]
    n_slots = e * b * cap
    gslot = torch.where(keep, se * (b * cap) + rows * cap + pos, n_slots)
    tok_slot = torch.empty_like(gslot).scatter_(-1, order, gslot)
    slot_pick = torch.full((n_slots + 1,), b * s * k, dtype=torch.long,
                           device=dev)
    # dropped assignments all land on the extra entry, which is cut off
    slot_pick.scatter_(0, gslot.reshape(-1),
                       (order + rows * (s * k)).reshape(-1))
    slot_pick = slot_pick[:-1]
    route = Dispatch(experts=experts, gates=gates,
                     tok_slot=tok_slot.reshape(-1), slot_pick=slot_pick)
    # a slot holds token slot_pick // k; an empty one reads zeros
    xe = _GatherRows.apply(x.reshape(b * s, d), (slot_pick // k)[:, None],
                           route.tok_slot.view(b * s, k))
    return xe.view(e, b * cap, d), route


def _row_combine(ye, route: Dispatch, b: int, s: int, dtype):
    """``ye (e, B·cap, d)`` → ``(B, s, d)``: each kept slot's output times
    its gate rounded to ``dtype``, summed over the token's ``k`` picks in
    ascending expert order (the order of the reference's scatter-add
    updates; one reduction, no scatter).  A dropped pick adds zero."""
    e_slots, d = ye.shape[0] * ye.shape[1], ye.shape[2]
    k = route.experts.shape[-1]
    picks = _GatherRows.apply(ye.reshape(e_slots, d), route.tok_slot[:, None],
                              route.slot_pick[:, None])
    y = picks.view(b * s, k, d) * route.gates.to(dtype).view(b * s, k, 1)
    return y.sum(1).view(b, s, d).to(dtype)


def _expert_ffn(cfg, xe, w1, w3, w2):
    """The gated expert chain ``(act(xe·w1) ⊙ xe·w3)·w2``, batched over the
    experts (``xe (e, n, d)``): three ``bmm``s, on cuBLAS on the card, as
    the reference leaves its expert einsums to XLA."""
    h = _act(cfg)(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2)


def moe_local(cfg, x, router, w1, w3, w2, shared, cap: int):
    """The MoE layer on one device's rows ``x (B, s, d)``: capacity dispatch
    per batch row at ``cap`` slots, the gated experts, the combine, plus
    the shared expert (an ``ffn`` dict, or None).  On a mesh member the
    expert and shared weights are its ``f`` slices and the result is its
    partial (the reference's ``local_moe``)."""
    b, s, _ = x.shape
    xe, route = _row_dispatch(cfg, x, router, cap)
    ye = _expert_ffn(cfg, xe, w1, w3, w2)
    y = _row_combine(ye, route, b, s, x.dtype)
    if shared is not None:
        y = y + ffn_apply(shared, cfg, x)
    return y


def moe_mesh(cfg, mem, xs: dict, pieces: dict, cap: int, run=None) -> dict:
    """The reference's ``local_moe`` over the members of ``mem`` (a
    ``sharding.Members``): member ``(j, m)`` runs ``moe_local`` on its data
    shard's rows ``xs[(j, m)]`` with its ``f`` slices ``pieces[(j, m)]``
    (``(router, w1, w3, w2, shared)``, as ``param_shardings`` places them),
    and one ``psum`` over the model axis sums each data shard's expert and
    shared-expert partials together.  Returns member -> the layer's output
    on its rows.  ``run(who, fn, x)`` computes ``fn(x)`` for member ``who``
    (default: on its device); the mesh executor passes its own, which
    norms ``x`` first and recomputes under ``cfg.remat`` in training."""
    from . import sharding
    if run is None:
        def run(who, fn, x):
            with sharding.on_member(mem.devices[who[0]][who[1]], who):
                return fn(x)
    parts = {}
    for who, x in xs.items():
        def fn(x, _w=pieces[who]):
            return moe_local(cfg, x, *_w, cap)
        parts[who] = run(who, fn, x)
    out = {}
    for j in range(mem.n_data):
        who = [(j, m) for m in range(mem.n_model)]
        res = sharding.psum([parts[w] for w in who], mem.devices[j], who)
        out.update({(j, m): r for m, r in enumerate(res)})
    return out


def moe_apply(p, cfg, x, capacity_factor: float = 1.25, rules=None):
    """Top-k MoE over ``x (B, s, d)``: capacity dispatch per batch row,
    the gated experts, the combine, plus the shared expert where ``p``
    has one.

    With ``rules`` whose ``mesh`` is set, the reference's mesh path: each
    member takes its block of ``p`` under ``param_shardings`` (the router
    whole, ``w1`` / ``w3`` and the shared ``w_gate`` / ``w_up`` on their
    ``f`` columns, ``w2`` and the shared ``w_down`` on their ``f`` rows),
    the rows split over the batch axes, and ``moe_mesh`` dispatches each
    data shard's rows locally (``cap`` from the whole ``s``) and ends in
    one ``psum``; the result is the whole ``(B, s, d)`` on the mesh's
    first device.  Where the batch does not divide by the batch axes the
    layer takes the local path, as the reference does.

    Tile-fusion reading (the reference's): the dispatch one-hot is the
    sparse A, the tokens of one expert form a fused tile, gather → two
    expert products with the intermediate local → scatter.  The routing
    is discontinuous: a near tie in a token's gates can pick another
    expert when the logits round differently."""
    from . import sharding
    b, s, _ = x.shape
    cap = moe_capacity(cfg, s, capacity_factor)
    mem = None if rules is None or rules.mesh is None else \
        sharding.Members(rules)
    if mem is None or b % mem.n_data:
        return moe_local(cfg, x, p["router"], p["w1"], p["w3"], p["w2"],
                         p.get("shared"), cap)
    if cfg.d_ff % mem.n_model:
        raise ValueError(f"the MoE layer slices d_ff {cfg.d_ff} over a "
                         f"model axis of {mem.n_model}")
    specs = sharding.param_shardings({"moe": p}, rules.mesh)["moe"]
    rows = mem.rows(b)
    xs, pieces = {}, {}
    for j, m in mem.all():
        dev = mem.devices[j][m]

        def block(t, spec, _c=mem.coords[j][m], _dev=dev):
            reg = sharding.spec_region(t.shape, spec, _c, mem.sizes)
            return sharding._to(t[tuple(slice(a, z) for a, z in reg)], _dev)
        w = sharding.tree_map(block, p, specs)
        pieces[(j, m)] = (w["router"], w["w1"], w["w3"], w["w2"],
                          w.get("shared"))
        xs[(j, m)] = sharding._to(x[rows[j]], dev)
    out = moe_mesh(cfg, mem, xs, pieces, cap)
    return torch.cat(sharding.gather([out[(j, 0)] for j in
                                      range(mem.n_data)], mem.first))


# ------------------------------------------------------------- embedding ----
def embed_init(gen, cfg, dtype, device=None) -> dict:
    return {
        "embed": init_weight(gen, (cfg.vocab_size, cfg.d_model), scale=0.02,
                             dtype=dtype, device=device),
        "lm_head": init_weight(gen, (cfg.d_model, cfg.vocab_size),
                               dtype=dtype, device=device),
    }
