"""Sub-quadratic sequence mixers: the chunked gated linear recurrence with
the mamba heads, and the ``sparse-band`` token mixer.

Twin of ``repro.models.ssm`` but for its mLSTM / sLSTM blocks (ROADMAP
Queue 1).  One engine, ``chunked_linear_recurrence``, carries per head a
state ``H ∈ R^{dk × dv}`` through

    H_t = a_t·H_{t-1} + k_tᵀ v_t,   o_t = q_t·H_t,   a_t ∈ (0, 1]

in chunks: within a chunk two products with the decay as a mask, across
chunks the carried state (the tile-fusion structure on the time axis).
It is plain PyTorch, as the reference computes it in XLA outside any
Pallas kernel; ``mamba_apply`` (hymba's mamba heads) runs it, or its
single step ``linear_recurrence_step`` in decode.

The band mix is ``A · (X · Wv)`` with the band ``A`` (``decay_band_csr``)
as the sparse operand, one ``tile_fused_matmul`` call a batch row, so the
schedule comes from the content-keyed cache and the backward runs the
transposed fused products (``api``'s autograd Functions).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.sparse.formats import CSR
from ..core.tilefusion import api
from ..core.tilefusion.spec import FusionSpec
from .layers import init_weight


def chunked_linear_recurrence(q, k, v, log_a, *, chunk: int = 128,
                              h0=None, normalize: bool = True):
    """q, k ``(B, S, H, dk)``; v ``(B, S, H, dv)``; log_a ``(B, S, H)``
    log-decay (≤ 0); h0 ``(B, H, dk, dv[+1])`` f32 or None.  Returns ``(o
    (B, S, H, dv) in q's dtype, h_final (B, H, dk, dv[+1]) f32)``.

    The reference's chunked form: f32 inside, S padded to whole chunks
    with zeros (``log_a = 0`` there, so the padding neither decays nor
    adds to the state).  Each chunk's own products (its intra-chunk
    output and its contribution to the state) are the reference's scan
    body, computed for all chunks in one batched op each; only the
    carried state is a loop over the chunks, ``H_c = exp(total_c)·H_{c-1}
    + U_c``, in the scan's order.  With ``normalize`` a ones column joins
    v, its output is the normalizer ``n``, and ``o = num / max(|n|,
    1)``."""
    b, s, h, dk = q.shape
    dv, out_dtype = v.shape[-1], q.dtype
    if normalize:
        v = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], -1)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    f32 = torch.float32
    q, k, v, log_a = (t.to(f32) for t in (q, k, v, log_a))
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    # (B, S, ...) → (B, nc, L, ...): chunk c is [:, c]
    q, k, v, log_a = (t.reshape(b, nc, chunk, *t.shape[2:])
                      for t in (q, k, v, log_a))
    cum = torch.cumsum(log_a, dim=2)                       # (B, nc, L, H)
    total = cum[:, :, -1]                                  # (B, nc, H)
    # intra-chunk: S_ij = (q_i·k_j) exp(cum_i - cum_j) for j <= i.  The
    # decay is masked in log space, before the exp: for j > i the exponent
    # is positive and overflows, and inf·0 in a masked product would
    # poison the gradients
    scores = torch.einsum("bclhk,bcmhk->bchlm", q, k)
    cum_t = cum.transpose(2, 3)                            # (B, nc, H, L)
    decay = cum_t[..., :, None] - cum_t[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    decay = decay.masked_fill(~causal, float("-inf"))
    o_intra = torch.einsum("bchlm,bcmhv->bclhv", scores * torch.exp(decay),
                           v)
    # each chunk's own contribution to the state, Σ_j (A_L / A_j) k_jᵀ v_j
    kdec = k * torch.exp(total[:, :, None] - cum)[..., None]
    u = torch.einsum("bclhk,bclhv->bchkv", kdec, v)
    hstate = q.new_zeros((b, h, dk, v.shape[-1])) if h0 is None \
        else h0.to(f32)
    entering = []                          # the state entering each chunk
    for c in range(nc):
        entering.append(hstate)
        hstate = hstate * torch.exp(total[:, c])[..., None, None] + u[:, c]
    # inter-chunk: o_i += A_i q_i · H_{c-1}
    o_inter = torch.einsum("bclhk,bchkv->bclhv",
                           q * torch.exp(cum)[..., None],
                           torch.stack(entering, 1))
    o = (o_inter + o_intra).reshape(b, nc * chunk, h, -1)[:, :s]
    if normalize:
        num, den = o[..., :dv], o[..., dv]
        o = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return o.to(out_dtype), hstate


def linear_recurrence_step(q, k, v, log_a, hstate, *,
                           normalize: bool = True):
    """One decode step: q, k ``(B, H, dk)``; v ``(B, H, dv)``; log_a ``(B,
    H)``; hstate ``(B, H, dk, dv[+1])`` f32.  Returns ``(o (B, H, dv) in
    q's dtype, the new state)``."""
    f32 = torch.float32
    dv = v.shape[-1]
    if normalize:
        v = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], -1)
    a = torch.exp(log_a.to(f32))[..., None, None]
    h_new = hstate * a + torch.einsum("bhk,bhv->bhkv", k.to(f32), v.to(f32))
    o = torch.einsum("bhk,bhkv->bhv", q.to(f32), h_new)
    if normalize:
        o = o[..., :dv] / torch.clamp(o[..., dv].abs(), min=1.0)[..., None]
    return o.to(q.dtype), h_new


@functools.lru_cache(maxsize=8)
def decay_band_csr(seq: int, window: int, decay: float = 0.9) -> CSR:
    """The fixed-decay linear recurrence unrolled on the time axis:
    ``A[i, j] = (1 - decay) * decay**(i - j)`` for
    ``max(0, i - window + 1) <= j <= i``, a lower-triangular band whose SpMM
    against values is the windowed recurrence ``o_i = (1-a) Σ_j a^{i-j}
    v_j``.  The ``(1 - decay)`` scale keeps every row sum below 1.

    Memoized, as the reference's: the same object comes back for the same
    arguments, so the content-keyed schedule cache hits on every layer and
    step without hashing the matrix again."""
    if not (0.0 < decay < 1.0):
        raise ValueError(f"decay must be in (0, 1), got {decay}")
    w = max(1, min(int(window), seq))
    counts = np.minimum(np.arange(seq) + 1, w)
    indptr = np.zeros(seq + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    indices = np.concatenate(
        [np.arange(i - c + 1, i + 1) for i, c in enumerate(counts)]
    ).astype(np.int32)
    rows = np.repeat(np.arange(seq), counts)
    data = ((1.0 - decay) * decay ** (rows - indices)).astype(np.float32)
    return CSR(seq, seq, indptr, indices, data)


#: one spec drives every band-mixer dispatch; small ``p`` because the band
#: is narrow and perfectly local
_BAND_SPEC = FusionSpec(p=4, cache_size=600_000.0, ct_size=256)


def band_mix_init(gen, cfg, dtype, device=None) -> dict:
    """Value and gate projections ``(d, inner)`` and the down projection
    ``(inner, d)``, ``inner = n_heads · ssm_head_dim``."""
    d = cfg.d_model
    inner = cfg.n_heads * cfg.ssm_head_dim
    return {
        "wv": init_weight(gen, (d, inner), dtype=dtype, device=device),
        "wz": init_weight(gen, (d, inner), dtype=dtype, device=device),
        "w_down": init_weight(gen, (inner, d), dtype=dtype, device=device),
    }


def band_mix_apply(p, cfg, x, a: CSR, *, backend: str = "cuda",
                   spec: FusionSpec | None = None) -> torch.Tensor:
    """x ``(B, S, d)`` → ``(B, S, d)``; ``a = decay_band_csr(S, ...)``.

    ``(A · (x_i · Wv) ⊙ silu(x_i · Wz)) · W_down`` for each batch row
    ``x_i``, the band product in f32 (``x`` and ``Wv`` cast up, the mix cast
    back to ``x``'s dtype), as the reference computes it.

    ``backend="cuda"`` is the twin of the reference's ``"xla"``, which
    forces its fused executor: Eq 3 would pick the unfused arm at the
    band's shapes (fused ratio 0.27, traffic saving 0.02 at stablelm's
    widths), and the mixer runs the fused GeMM-SpMM kernel all the same.
    On CPU tensors it runs the kernel arm's glue with the kernels' plain
    versions; ``"torch"`` is the plain fused executor on any device, and
    ``"auto"`` / ``"unfused"`` take those arms of ``tile_fused_matmul``."""
    spec = _BAND_SPEC if spec is None else spec
    wv = p["wv"].float()
    mixed = torch.stack([
        api.tile_fused_matmul(a, x[i].float(), wv, backend=backend,
                              spec=spec)
        for i in range(x.shape[0])])
    z = x @ p["wz"]
    return (mixed.to(x.dtype) * F.silu(z)) @ p["w_down"]


def mamba_init(gen, cfg, dtype, device=None) -> dict:
    """Selective-SSM heads (hymba's mamba half): ``w_in (d, 2·inner)`` (the
    x and z branches), ``w_bc (inner, 2·h·n)``, ``w_out_proj (inner, d)``
    at ``init_weight``'s default scale in ``dtype``; ``w_dt (inner, h)``
    at scale 0.02 and ``a_log (h,)`` zeros in f32 whatever ``dtype``, as
    the reference holds them."""
    d = cfg.d_model
    h, dh, n = cfg.n_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = h * dh
    return {
        "w_in": init_weight(gen, (d, 2 * inner), dtype=dtype, device=device),
        "w_bc": init_weight(gen, (inner, 2 * h * n), dtype=dtype,
                            device=device),
        "w_dt": init_weight(gen, (inner, h), scale=0.02, device=device),
        "a_log": torch.zeros(h, dtype=torch.float32, device=device),
        "w_out_proj": init_weight(gen, (inner, d), dtype=dtype,
                                  device=device),
    }


def mamba_apply(p, cfg, x, *, cache=None):
    """x ``(B, S, d)`` → ``(y (B, S, d), state (B, H, n, dh) f32)``.

    The SSD / linear-attention form of the reference: C is the query, B
    the key, ``x·dt`` the value and ``-dt·exp(a_log)`` the log-decay, dt
    the softplus of an f32 projection.  S > 1 (training or a batched
    prefill) runs ``chunked_linear_recurrence`` (chunk ``min(128, S)``,
    no normalizer) from ``cache``, the carried state (None: zeros); S ==
    1 runs ``linear_recurrence_step``.  The output is gated by
    ``silu(z)``."""
    b, s, _ = x.shape
    h, dh, n = cfg.n_heads, cfg.ssm_head_dim, cfg.ssm_state
    xin, z = (x @ p["w_in"]).chunk(2, dim=-1)              # (B, S, inner)
    bc = (xin @ p["w_bc"]).reshape(b, s, h, 2 * n)
    b_in, c_out = bc[..., :n], bc[..., n:]
    dt = F.softplus(xin.float() @ p["w_dt"])               # (B, S, H)
    log_decay = -dt * torch.exp(p["a_log"])
    v = xin.reshape(b, s, h, dh) * dt[..., None].to(x.dtype)
    if s > 1:
        o, state = chunked_linear_recurrence(
            c_out, b_in, v, log_decay, chunk=min(128, s), h0=cache,
            normalize=False)
    else:
        h0 = cache if cache is not None else \
            x.new_zeros((b, h, n, dh), dtype=torch.float32)
        o, state = linear_recurrence_step(
            c_out[:, 0], b_in[:, 0], v[:, 0], log_decay[:, 0], h0,
            normalize=False)
        o = o[:, None]
    o = o.reshape(b, s, -1) * F.silu(z)
    return o @ p["w_out_proj"], state
