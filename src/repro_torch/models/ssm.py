"""Sub-quadratic sequence mixers: the chunked gated linear recurrence with
the mamba heads and xLSTM's mLSTM block, xLSTM's sLSTM block, and the
``sparse-band`` token mixer.

Twin of ``repro.models.ssm``.  One engine, ``chunked_linear_recurrence``,
carries per head a state ``H ∈ R^{dk × dv}`` through

    H_t = a_t·H_{t-1} + k_tᵀ v_t,   o_t = q_t·H_t,   a_t ∈ (0, 1]

in chunks: within a chunk two products with the decay as a mask, across
chunks the carried state (the tile-fusion structure on the time axis).
It is plain PyTorch, as the reference computes it in XLA outside any
Pallas kernel; ``mamba_apply`` (hymba's mamba heads) and ``mlstm_apply``
(with the normalizer) run it, or its single step
``linear_recurrence_step`` in decode.  The sLSTM is a scan over time of
an elementwise exponential-gated LSTM with a dense recurrent product,
one step at a time in f32, as the reference's ``lax.scan``.

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
    return band_mix_gated(p, x, a, backend=backend, spec=spec) @ p["w_down"]


def band_mix_gated(p, x, a: CSR, *, backend: str = "cuda",
                   spec: FusionSpec | None = None) -> torch.Tensor:
    """``band_mix_apply`` before ``W_down``: ``A · (x_i · Wv) ⊙ silu(x_i ·
    Wz)``, ``(B, S, c)`` for the ``c`` columns ``p["wv"]`` / ``p["wz"]``
    hold (a mesh member's slice: the fused product at ``c_col = c``)."""
    spec = _BAND_SPEC if spec is None else spec
    wv = p["wv"].float()
    mixed = torch.stack([
        api.tile_fused_matmul(a, x[i].float(), wv, backend=backend,
                              spec=spec)
        for i in range(x.shape[0])])
    z = x @ p["wz"]
    return mixed.to(x.dtype) * F.silu(z)


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
    xin, z = (x @ p["w_in"]).chunk(2, dim=-1)              # (B, S, inner)
    o, state = mamba_mix(p, cfg, xin, z, cache=cache)
    return o @ p["w_out_proj"], state


def mamba_mix(p, cfg, xin, z, *, heads=None, cache=None):
    """``mamba_apply`` between ``W_in`` and ``W_out_proj``: ``xin (B, S,
    inner)`` whole and the gate ``z``.  ``heads = (h0, h1)`` computes those
    heads only (a mesh member's; default all): ``z`` and ``cache`` are
    theirs, and their columns of ``w_bc`` / ``w_dt`` / ``a_log`` are sliced
    here.  Returns ``(o (B, S, (h1 - h0)·dh) gated, state (B, h1 - h0, n,
    dh) f32)``."""
    b, s, _ = xin.shape
    dh, n = cfg.ssm_head_dim, cfg.ssm_state
    h0, h1 = (0, cfg.n_heads) if heads is None else heads
    h = h1 - h0
    w_bc, w_dt, a_log = p["w_bc"], p["w_dt"], p["a_log"]
    if heads is not None:
        w_bc = w_bc[:, h0 * 2 * n:h1 * 2 * n]
        w_dt, a_log = w_dt[:, h0:h1], a_log[h0:h1]
    bc = (xin @ w_bc).reshape(b, s, h, 2 * n)
    b_in, c_out = bc[..., :n], bc[..., n:]
    dt = F.softplus(xin.float() @ w_dt)                    # (B, S, h)
    log_decay = -dt * torch.exp(a_log)
    v = xin[..., h0 * dh:h1 * dh].reshape(b, s, h, dh) * \
        dt[..., None].to(xin.dtype)
    if s > 1:
        o, state = chunked_linear_recurrence(
            c_out, b_in, v, log_decay, chunk=min(128, s), h0=cache,
            normalize=False)
    else:
        h0_ = cache if cache is not None else \
            xin.new_zeros((b, h, n, dh), dtype=torch.float32)
        o, state = linear_recurrence_step(
            c_out[:, 0], b_in[:, 0], v[:, 0], log_decay[:, 0], h0_,
            normalize=False)
        o = o[:, None]
    return o.reshape(b, s, -1) * F.silu(z), state


def mlstm_init(gen, cfg, dtype, device=None) -> dict:
    """xLSTM's mLSTM block: ``w_up (d, 2·inner)`` (the main and gate
    branches), per-head ``wq``, ``wk``, ``wv (inner, inner)`` and ``w_down
    (inner, d)`` in ``dtype``; the forget and input gates ``w_f``, ``w_i
    (inner, h)`` at scale 0.02 in f32 whatever ``dtype``, as the reference
    holds them."""
    d = cfg.d_model
    h, dh = cfg.n_heads, cfg.ssm_head_dim
    inner = h * dh
    return {
        "w_up": init_weight(gen, (d, 2 * inner), dtype=dtype, device=device),
        "wq": init_weight(gen, (inner, inner), dtype=dtype, device=device),
        "wk": init_weight(gen, (inner, inner), dtype=dtype, device=device),
        "wv": init_weight(gen, (inner, inner), dtype=dtype, device=device),
        "w_f": init_weight(gen, (inner, h), scale=0.02, device=device),
        "w_i": init_weight(gen, (inner, h), scale=0.02, device=device),
        "w_down": init_weight(gen, (inner, d), dtype=dtype, device=device),
    }


def mlstm_apply(p, cfg, x, *, cache=None):
    """x ``(B, S, d)`` → ``(y (B, S, d), state (B, H, dh, dh + 1) f32)``.

    The matrix memory as a normalized linear recurrence: q, k (scaled by
    ``1/sqrt(dh)``, then by the input gate) and v per head, the
    log-sigmoid forget gate as the log-decay; both gate logits in f32.  S >
    1 (training or a batched prefill) runs ``chunked_linear_recurrence``
    (chunk ``min(128, S)``) from ``cache``, the carried state (None:
    zeros); S == 1 runs ``linear_recurrence_step``.  The output is gated by
    ``silu(gate)``."""
    main, gate = (x @ p["w_up"]).chunk(2, dim=-1)          # (B, S, inner)
    o, state = mlstm_mix(p, cfg, main, gate, cache=cache)
    return o @ p["w_down"], state


def mlstm_mix(p, cfg, main, gate, *, qkv=None, heads=None, cache=None):
    """``mlstm_apply`` between ``W_up`` and ``W_down``: ``main (B, S,
    inner)`` whole; q, k and v are ``main``'s products with ``p``'s ``wq``
    / ``wk`` / ``wv``, or ``qkv`` where given.  ``heads = (h0, h1)``
    computes those heads only (a mesh member's; default all): ``qkv``,
    the ``gate`` columns and ``cache`` are theirs, and their columns of
    ``w_f`` / ``w_i`` are sliced here.  Returns ``(o (B, S, (h1 - h0)·dh)
    gated, state)``."""
    b, s, _ = main.shape
    dh = cfg.ssm_head_dim
    w_f, w_i = p["w_f"], p["w_i"]
    if heads is not None:
        w_f, w_i = w_f[:, heads[0]:heads[1]], w_i[:, heads[0]:heads[1]]
    if qkv is None:
        q = (main @ p["wq"]).reshape(b, s, -1, dh)
        k = (main @ p["wk"]).reshape(b, s, -1, dh) / dh ** 0.5
        v = (main @ p["wv"]).reshape(b, s, -1, dh)
    else:
        q, k, v = qkv
        q = q.reshape(b, s, -1, dh)
        k = k.reshape(b, s, -1, dh) / dh ** 0.5
        v = v.reshape(b, s, -1, dh)
    main32 = main.float()
    log_f = F.logsigmoid(main32 @ w_f)                     # (B, S, h)
    i_gate = torch.exp(F.logsigmoid(main32 @ w_i))
    k = k * i_gate[..., None].to(k.dtype)
    if s > 1:
        o, state = chunked_linear_recurrence(q, k, v, log_f,
                                             chunk=min(128, s), h0=cache)
    else:
        h0 = cache if cache is not None else \
            main.new_zeros((b, q.shape[2], dh, dh + 1), dtype=torch.float32)
        o, state = linear_recurrence_step(q[:, 0], k[:, 0], v[:, 0],
                                          log_f[:, 0], h0)
        o = o[:, None]
    return o.reshape(b, s, -1) * F.silu(gate), state


def slstm_init(gen, cfg, dtype, device=None) -> dict:
    """xLSTM's sLSTM block: ``w_up (d, 4·inner)`` (the z, i, f, o
    pre-activations), ``w_rec (inner, 4·inner)`` at scale 0.02 and
    ``w_down (inner, d)``, all in ``dtype``."""
    d = cfg.d_model
    inner = cfg.n_heads * cfg.ssm_head_dim
    return {
        "w_up": init_weight(gen, (d, 4 * inner), dtype=dtype, device=device),
        "w_rec": init_weight(gen, (inner, 4 * inner), scale=0.02,
                             dtype=dtype, device=device),
        "w_down": init_weight(gen, (inner, d), dtype=dtype, device=device),
    }


def slstm_apply(p, cfg, x, *, cache=None):
    """x ``(B, S, d)`` → ``(y (B, S, d), (c, hid) each (B, inner) f32)``.

    The reference's scan, one step at a time in f32 from ``cache`` (None:
    zeros): ``u = pre_t + hid·w_rec``, then ``c = σ(f)·c + σ(i)·tanh(z)``
    and ``hid = σ(o)·tanh(c)``.  ``w_rec`` is cast to f32 once a call, not
    once a step (the same values).  A step is a few small launches, so a
    long sequence is bound by the host (ROADMAP Queue 2)."""
    hs, carry = slstm_scan(p, cfg, (x @ p["w_up"]).float(), cache=cache)
    return hs.to(x.dtype) @ p["w_down"], carry


def slstm_scan(p, cfg, pre, *, cache=None):
    """``slstm_apply``'s time loop on the f32 pre-activations ``pre (B, S,
    4·inner)`` (``x·W_up``): returns ``(hid of every step (B, S, inner)
    f32, (c, hid))``.  A mesh member runs it whole on its rows, ``w_rec``
    replicated, and multiplies its columns of the result by its rows of
    ``W_down``."""
    b, s, _ = pre.shape
    inner = cfg.n_heads * cfg.ssm_head_dim
    w_rec = p["w_rec"].float()
    if cache is None:
        c = torch.zeros((b, inner), dtype=torch.float32, device=pre.device)
        hid = torch.zeros_like(c)
    else:
        c, hid = cache
    hs = []
    for t in range(s):
        u = torch.addmm(pre[:, t], hid, w_rec)
        i, f, o = torch.sigmoid(u[:, inner:]).chunk(3, dim=-1)
        c = torch.addcmul(f * c, i, torch.tanh(u[:, :inner]))
        hid = o * torch.tanh(c)
        hs.append(hid)
    return torch.stack(hs, dim=1), (c, hid)
