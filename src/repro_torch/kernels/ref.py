"""Plain PyTorch versions of the port's CUDA kernels.

Twins of the oracles in ``repro.kernels.ref``, written for the kernels'
arithmetic: every sum runs in float32 and the result is cast to the
operand dtype once.  The wavefront-0 versions gather the fused rows from
the float32 ``D1`` tile, as the kernels (and the Pallas kernels they
replace) do, before ``d1`` is rounded to the operand dtype.  The wrappers
use these for CPU tensors; on the card they are what ``chip_smoke.py``
holds each kernel against.  Sums over the ELL width run slot by slot, so
no ``(..., w, c)`` gather is ever materialized.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: score of a masked (query, key) pair, as in the reference: finite, so a
#: row whose every key is masked gets the mean of V, never a NaN
NEG_INF = -1e30


def ell_rows_f32(cols: torch.Tensor, vals: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """``rows[..., :] = Σ_w vals[..., w] · table[cols[..., w], :]`` in f32."""
    cols = cols.long()
    acc = torch.zeros(cols.shape[:-1] + (table.shape[-1],),
                      dtype=torch.float32, device=table.device)
    for w in range(cols.shape[-1]):
        acc += vals[..., w, None].float() * table[cols[..., w]].float()
    return acc


def _tile_offsets(cols0: torch.Tensor, t: int) -> torch.Tensor:
    """Tile-local ELL columns → rows of the flattened ``(T0 * t, c)`` D1."""
    base = torch.arange(cols0.shape[0], device=cols0.device) * t
    return cols0.long() + base[:, None, None]


def _segments(bounds: torch.Tensor):
    """``(segment, element)`` of every element of the ``[start, end)``
    ranges in ``bounds`` (``(n, 2)``; empty and ``(-1, -1)`` ranges hold
    none), in range order."""
    starts = bounds[:, 0].long()
    lens = (bounds[:, 1].long() - starts).clamp_min(0)
    seg = torch.repeat_interleave(torch.arange(len(lens),
                                               device=bounds.device), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = torch.arange(len(seg), device=bounds.device) - first[seg]
    return seg, starts[seg] + pos


def spmm_ell(cols, vals, x, *, tails=None, out=None, out_rows=None):
    """``out[r(i)] = Σ_w vals[i, w] · X[cols[i, w]] + Σ_{k ∈ tail(i)}
    tail_vals[k] · X[tail_cols[k]]``, walking the kernel's plan: each row's
    body and tail range in f32; a split row's chunks as f32 partials, added
    to its body in chunk order; one rounding.  ``r(i)`` is ``out_rows[i]``
    (a pad target ``out.shape[0]`` is not written) or ``i``."""
    acc = ell_rows_f32(cols, vals, x)
    if tails is not None and tails.cols.numel():
        def products(lanes):
            return (tails.vals[lanes, None].float()
                    * x[tails.cols[lanes].long()].float())

        rows, lanes = _segments(tails.ranges)
        acc.index_add_(0, rows, products(lanes))
        chunk, lanes = _segments(tails.chunks[:, 1:])
        partial = torch.zeros((len(tails.chunks), x.shape[1]),
                              dtype=torch.float32, device=x.device)
        partial.index_add_(0, chunk, products(lanes))
        split = tails.split_rows.long()
        first = tails.split_ptr[:-1].long()
        n_chunks = tails.split_ptr[1:].long() - first
        for k in range(int(n_chunks.max()) if len(n_chunks) else 0):
            on = n_chunks > k
            acc[split[on]] += partial[first[on] + k]
    if out_rows is None:
        if out is None:
            return acc.to(x.dtype)
        return out.copy_(acc)
    target = out_rows.long()
    if bool(((target < 0) | (target > out.shape[0])).any()):
        raise ValueError(f"spmm_ell: out_rows outside [0, {out.shape[0]}]")
    keep = target != out.shape[0]
    out[target[keep]] = acc[keep].to(out.dtype)
    return out


def tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, *, t: int):
    """``(d1, rows0)``: ``d1 = B @ C`` and the tiles' fused rows."""
    d1 = b.float() @ c.float()
    rows = ell_rows_f32(_tile_offsets(cols0, t), vals0, d1)
    return d1.to(b.dtype), rows.to(b.dtype)


def tile_fused_spmm_spmm_wf0(op1_cols, op1_vals, d1_spill, cols0, vals0, c,
                             *, t: int):
    """``(d1, rows0)``: op-1 ELL over global ``C`` plus the spill delta,
    then the tiles' fused rows."""
    c_col = c.shape[1]
    d1 = (ell_rows_f32(op1_cols, op1_vals, c).reshape(-1, c_col)
          + d1_spill.float())
    rows = ell_rows_f32(_tile_offsets(cols0, t), vals0, d1)
    return d1.to(c.dtype), rows.to(c.dtype)


# ---- yardsticks: the unfused library chains of the wavefront-0 kernels ----
# Nothing in the port calls these; ``chip_smoke.py`` times them beside the
# kernels as the library call that computes the same ``(d1, rows0)``.


def ell_csr(cols, vals, n_cols: int, spill=None):
    """The nonzero entries of an ELL (its leading axes flattened into rows),
    plus COO spill lanes ``(rows, cols, vals)`` if given, as one
    ``torch.sparse_csr_tensor`` of ``n_cols`` columns (duplicates summed)."""
    w = cols.shape[-1]
    cols = cols.reshape(-1, w).long()
    vals = vals.reshape(-1, w)
    keep = vals != 0
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    idx_r, idx_c, v = rows.expand_as(cols)[keep], cols[keep], vals[keep]
    if spill is not None:
        sr, sc, sv = spill
        idx_r = torch.cat([idx_r, sr.long()])
        idx_c = torch.cat([idx_c, sc.long()])
        v = torch.cat([v, sv.to(v.dtype)])
    coo = torch.sparse_coo_tensor(torch.stack([idx_r, idx_c]), v,
                                  (cols.shape[0], n_cols),
                                  check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def fused_rows_csr(cols0, vals0, t: int):
    """The tiles' fused rows as a CSR over the ``T0 * t`` rows of ``d1``
    (global column ``v * t + col``)."""
    return ell_csr(_tile_offsets(cols0, t), vals0, cols0.shape[0] * t)


def gemm_spmm_wf0_library(csr0, b, c):
    """``torch.matmul(b, c)``, then ``torch.sparse.mm`` of ``fused_rows_csr``
    over it: ``d1`` and the fused rows ``(T0 * j0_max, c_col)``."""
    d1 = torch.matmul(b, c)
    return d1, torch.sparse.mm(csr0, d1)


def spmm_spmm_wf0_library(csr1, csr0, c):
    """``torch.sparse.mm`` of op-1 (``ell_csr`` of its ELL with its spill
    lanes) over ``c``, then of ``fused_rows_csr`` over that ``d1``."""
    d1 = torch.sparse.mm(csr1, c)
    return d1, torch.sparse.mm(csr0, d1)


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """The FFN kernels' activation: ``gelu`` is the tanh approximation
    (``jax.nn.gelu``'s default), ``silu``, or ``none``."""
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "silu":
        return F.silu(h)
    if act == "none":
        return h
    raise ValueError(f"act must be 'gelu', 'silu' or 'none', got {act!r}")


def ffn(x, w1, w2, act: str = "gelu"):
    """Ungated ``act(x @ w1) @ w2``; H stays f32 (no rounding between the
    two products)."""
    h = activation(x.float() @ w1.float(), act)
    return (h @ w2.float()).to(x.dtype)


def moe_ffn(x, w1, w2, act: str = "silu"):
    """``act(x[e] @ w1[e]) @ w2[e]`` per expert ``e``.  ``act="none"``
    applies no activation, as the TPU kernel does (the JAX oracle maps it
    to gelu; ROADMAP Queue 3)."""
    h = activation(torch.bmm(x.float(), w1.float()), act)
    return torch.bmm(h, w2.float()).to(x.dtype)


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """``(sq, sk)`` bool, True where query ``i`` may see key ``j``."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              sm_scale: float | None = None):
    """q ``(B, H, Sq, D)``, k/v ``(B, Hkv, Sk, D)`` with ``H % Hkv == 0``:
    softmax attention in f32 with masked scores set to ``NEG_INF``; K/V
    are repeated to H heads (query head ``h`` reads K/V head
    ``h // (H // Hkv)``)."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = attention_mask(q.shape[2], k.shape[2], causal=causal,
                          window=window, device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
