"""Work counts from shapes and nonzeros: the operations and compulsory
bytes of the products the benchmark's models define.

A product's FLOPs are ``2·m·k·n`` dense and ``2·nnz·n`` sparse.  Its
compulsory bytes read each operand once and write each result once:
a CSR matrix is its row pointers, column indices and values (4 bytes
each), a dense matrix its elements at ``elem`` bytes.  Nothing here reads
the program, so a change to the program cannot change the counts.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def least_s(self, flops_per_s: float) -> float:
        """The least time on the card: the larger of the compute and the
        memory bound."""
        return max(self.flops / flops_per_s,
                   self.bytes / PEAKS["hbm_bytes_per_s"])


def csr_bytes(n_rows: int, nnz: int) -> int:
    return 4 * (n_rows + 1) + 8 * nnz


def gemm_spmm_forward(n_out: int, n_in: int, nnz: int, b_col: int,
                      c_col: int, elem: int = 4) -> Work:
    """``D = A·(B·C)``: A ``(n_out, n_in)`` sparse, B ``(n_in, b_col)``, C
    ``(b_col, c_col)``."""
    flops = 2 * n_in * b_col * c_col + 2 * nnz * c_col
    nbytes = (csr_bytes(n_out, nnz)
              + elem * (n_in * b_col + b_col * c_col + n_out * c_col))
    return Work(flops, nbytes)


def gemm_spmm_backward(n_out: int, n_in: int, nnz: int, b_col: int,
                       c_col: int, need_db: bool, elem: int = 4) -> Work:
    """The backward of ``D = A·(B·C)``: ``dC = Bᵀ·(Aᵀ·Ḋ)`` always, ``dB =
    Aᵀ·(Ḋ·Cᵀ)`` when B needs a gradient.  Reads A, Ḋ, B (and C for dB)
    once; writes dC (and dB)."""
    flops = 2 * nnz * c_col + 2 * n_in * b_col * c_col
    nbytes = (csr_bytes(n_out, nnz)
              + elem * (n_out * c_col + n_in * b_col + b_col * c_col))
    if need_db:
        flops += 2 * n_out * c_col * b_col + 2 * nnz * b_col
        nbytes += elem * (b_col * c_col + n_in * b_col)
    return Work(flops, nbytes)


# ------------------------------------------------------------------ GCN ----
def gcn_dims(cfg: dict) -> list:
    return ([cfg["in_dim"]] + [cfg["hidden_dim"]] * (cfg["n_layers"] - 1)
            + [cfg["out_dim"]])


def gcn_calls(cfg: dict, nnz: int) -> list:
    """Each layer's ``Â·(H·W)`` forward, then each layer's backward (the
    first layer's features need no gradient), as ``Work`` items."""
    n, dims = cfg["n_nodes"], gcn_dims(cfg)
    pairs = list(zip(dims[:-1], dims[1:]))
    fwd = [gemm_spmm_forward(n, n, nnz, b, c) for b, c in pairs]
    bwd = [gemm_spmm_backward(n, n, nnz, b, c, need_db=i > 0)
           for i, (b, c) in enumerate(pairs)]
    return fwd + bwd


def gcn_step_flops(cfg: dict, nnz: int) -> float:
    """One full-batch training step: every layer's two products forward
    and its gradient products backward."""
    return sum(w.flops for w in gcn_calls(cfg, nnz))


# ------------------------------------------------------------------- LM ----
def band_nnz(seq: int, window: int) -> int:
    """Nonzeros of the causal decay band: ``min(i + 1, window)`` a row."""
    w = max(1, min(window, seq))
    return w * (w + 1) // 2 + (seq - w) * w


def lm_inner(cfg: dict) -> int:
    return cfg["n_heads"] * cfg.get("ssm_head_dim",
                                    cfg["d_model"] // cfg["n_heads"])


def lm_band_calls(cfg: dict, batch: int, seq: int) -> list:
    """The band mixer's ``A·(X·Wv)``, one call a batch row a layer, forward
    then backward (X and Wv both need gradients), f32 operands."""
    d, inner = cfg["d_model"], lm_inner(cfg)
    nnz = band_nnz(seq, cfg["band_window"])
    calls = cfg["n_layers"] * batch
    return ([gemm_spmm_forward(seq, seq, nnz, d, inner)] * calls
            + [gemm_spmm_backward(seq, seq, nnz, d, inner, need_db=True)]
            * calls)


def lm_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """One training step of the sparse-band LM: every matmul from its
    shapes (the value, gate and down projections of the mixer, the gated
    FFN's three, the output head) and the band product, forward once and
    backward twice that; the embedding gather and any recompute are not
    counted."""
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    inner = lm_inner(cfg)
    tokens = batch * seq
    per_layer = (2 * tokens * (3 * d * inner + 3 * d * f)
                 + 2 * batch * band_nnz(seq, cfg["band_window"]) * inner)
    forward = cfg["n_layers"] * per_layer + 2 * tokens * d * v
    return 3 * forward
