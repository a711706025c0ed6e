"""Heterogeneous multi-relation fusion — one dispatch for many SpMMs.

A copy of ``repro.core.tilefusion.hetero`` on PyTorch tensors.
Hetero-GNN workloads (RGCN-style) run one small SpMM per relation.  This
module stacks the per-relation adjacencies **block-diagonally** into one
CSR, stacks the dense per-relation operands to match, and routes the whole
thing through ``api.tile_fused_matmul`` — one Algorithm-1 inspection, one
schedule-cache entry, one dispatch — then un-stacks the per-relation
outputs.  Every backend and knob works unchanged: a block-diagonal stack
is just another sparse pattern to them (``spec.reorder`` and
``spec.autotune`` included), and autograd flows through the stacking.

Stacking geometry: relation ``r``'s adjacency ``a_r`` is ``(n_j_r,
n_i_r)``; it is placed on a **square pitch** ``S_r = max(n_j_r, n_i_r)``
on both axes, so each block's row offset equals its column offset and the
stacked matrix is square.  The pad rows and columns are empty.

Math (GeMM-SpMM): with ``A = blockdiag(a_r)``, ``B = blockdiag(b_r)``
(dense, assembled per call on the row pitch) and ``C = vstack(c_r)``,
``D = A·(B·C)`` has ``D[rows of block r] = a_r·(b_r·c_r)``.  SpMM-SpMM
stacks the op-1 CSRs block-diagonally on the same row pitch instead.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..sparse.formats import CSR, block_diag_csr, csr_content_digest
from . import api
from .spec import FusionSpec


@dataclasses.dataclass(frozen=True)
class HeteroStack:
    """A block-diagonal stack of relation adjacencies plus its geometry.

    ``pitches[r]`` is the square per-relation pitch ``max(n_j_r, n_i_r)``;
    ``offsets[r]`` the (row == column) start of block ``r``; ``row_sizes``
    / ``col_sizes`` the true per-relation shapes used to un-stack outputs
    and validate operands."""

    a: CSR
    offsets: tuple
    pitches: tuple
    row_sizes: tuple
    col_sizes: tuple

    @property
    def n_relations(self) -> int:
        return len(self.pitches)


_stack_cache: "collections.OrderedDict" = collections.OrderedDict()
_stack_lock = threading.Lock()
#: Entries the stack cache keeps (LRU): one per distinct relation set.
STACK_CACHE_ENTRIES = 64


def _stack_cache_get(key):
    with _stack_lock:
        value = _stack_cache.get(key)
        if value is not None:
            _stack_cache.move_to_end(key)
        return value


def _stack_cache_put(key, value):
    with _stack_lock:
        _stack_cache[key] = value
        _stack_cache.move_to_end(key)
        while len(_stack_cache) > STACK_CACHE_ENTRIES:
            _stack_cache.popitem(last=False)


def clear_stack_cache() -> None:
    with _stack_lock:
        _stack_cache.clear()


def stack_adjacencies(adjs) -> HeteroStack:
    """Square-pitch block-diagonal stack of the relation adjacencies,
    memoized by the tuple of content digests (rebuilt only when the
    relation set changes)."""
    adjs = list(adjs)
    if not adjs:
        raise ValueError("need at least one relation")
    key = ("adj",) + tuple(csr_content_digest(a) for a in adjs)
    stack = _stack_cache_get(key)
    if stack is not None:
        return stack
    pitches = tuple(max(a.n_rows, a.n_cols) for a in adjs)
    offsets = tuple(int(o) for o in
                    np.concatenate([[0], np.cumsum(pitches)[:-1]]))
    a = block_diag_csr(adjs, row_sizes=pitches, col_sizes=pitches)
    stack = HeteroStack(a=a, offsets=offsets, pitches=pitches,
                        row_sizes=tuple(m.n_rows for m in adjs),
                        col_sizes=tuple(m.n_cols for m in adjs))
    _stack_cache_put(key, stack)
    return stack


def _stack_op1(stack: HeteroStack, a1s) -> CSR:
    """Block-diagonal stack of the SpMM-SpMM op-1 CSRs: rows on the
    adjacency stack's pitch (op-1 row ids line up with the stacked A's
    column ids), columns exact (C is a plain row concatenation).
    Memoized like the adjacency stack."""
    key = ("op1", stack.pitches) + tuple(csr_content_digest(m) for m in a1s)
    a1 = _stack_cache_get(key)
    if a1 is not None:
        return a1
    a1 = block_diag_csr(a1s, row_sizes=stack.pitches,
                        col_sizes=[m.n_cols for m in a1s])
    _stack_cache_put(key, a1)
    return a1


def _block_diag_dense(stack: HeteroStack, bs) -> torch.Tensor:
    """The dense block-diagonal first operand ``B = blockdiag(b_r)``, each
    block's rows padded to its pitch.  ``torch.block_diag`` is
    differentiable, so gradients flow back to each ``b_r``."""
    for size, b in zip(stack.col_sizes, bs):
        if b.shape[0] != size:
            raise ValueError(f"dense operand has {b.shape[0]} rows; the "
                             f"relation's adjacency has {size} columns")
    return torch.block_diag(*[F.pad(b, (0, 0, 0, pitch - b.shape[0]))
                              for pitch, b in zip(stack.pitches, bs)])


def _unstack_rows(d: torch.Tensor, stack: HeteroStack) -> list:
    """Per-relation blocks of the stacked output (views of ``d``)."""
    return [d[off:off + nj] for off, nj in zip(stack.offsets,
                                                 stack.row_sizes)]


def hetero_fused_matmul(relations, *, backend: str = "auto",
                        spec: FusionSpec | None = None) -> list:
    """Per-relation ``D_r = a_r @ (b_or_a1_r @ c_r)`` as ONE dispatch.

    Args:
      relations: sequence of ``(a_r, b_or_a1_r, c_r)`` triples — the
        operands ``tile_fused_matmul`` takes, one per relation.  All
        relations must be the same op pair (all-dense or all-CSR middle
        operands) and share ``c_col``.
      backend, spec: forwarded verbatim to ``tile_fused_matmul``; every
        knob applies to the stacked problem as a whole.

    Returns the list of per-relation outputs ``[d_r]`` (``(n_j_r,
    c_col)`` each), what the per-relation loop would produce.  The stacked
    CSRs are memoized by the relation set's content digests, so a serving
    loop over a fixed relation set re-stacks nothing and hits one schedule
    entry; only the dense block-diagonal assembly runs per call.
    """
    rels = [tuple(r) for r in relations]
    if not rels:
        raise ValueError("need at least one relation")
    if any(len(r) != 3 for r in rels):
        raise ValueError("each relation is an (a, b_or_a1, c) triple")
    sparse_flags = {isinstance(r[1], CSR) for r in rels}
    if len(sparse_flags) != 1:
        raise ValueError("relations mix dense and sparse first operands; "
                         "the stacked dispatch needs one op pair")
    b_is_sparse = sparse_flags.pop()
    c_cols = {int(r[2].shape[1]) for r in rels}
    if len(c_cols) != 1:
        raise ValueError(f"relations disagree on c_col ({sorted(c_cols)}); "
                         f"stacked outputs share one feature width")
    stack = stack_adjacencies([r[0] for r in rels])
    if b_is_sparse:
        for (_, a1_r, c_r), n_i in zip(rels, stack.col_sizes):
            if a1_r.n_rows != n_i:
                raise ValueError(f"op-1 has {a1_r.n_rows} rows; the "
                                 f"adjacency has {n_i} columns")
            if c_r.shape[0] != a1_r.n_cols:
                raise ValueError(f"c has {c_r.shape[0]} rows; op-1 has "
                                 f"{a1_r.n_cols} columns")
        op1 = _stack_op1(stack, [r[1] for r in rels])
    else:
        op1 = _block_diag_dense(stack, [r[1] for r in rels])
        for (_, b_r, c_r) in rels:
            if c_r.shape[0] != b_r.shape[1]:
                raise ValueError(f"c has {c_r.shape[0]} rows; b has "
                                 f"{b_r.shape[1]} columns")
    c_cat = torch.cat([r[2] for r in rels], dim=0)
    d = api.tile_fused_matmul(stack.a, op1, c_cat, backend=backend,
                              spec=spec)
    return _unstack_rows(d, stack)


def hetero_loop_matmul(relations, *, backend: str = "auto",
                       spec: FusionSpec | None = None) -> list:
    """The per-relation baseline the stack replaces: one
    ``tile_fused_matmul`` dispatch per relation (N inspections, N cache
    entries, N dispatches).  The parity oracle and the timing baseline."""
    return [api.tile_fused_matmul(a, b_or_a1, c, backend=backend, spec=spec)
            for a, b_or_a1, c in relations]
