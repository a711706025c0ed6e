"""Hybrid-ELL SpMM: the ELL body and each row's spill tail in one pass,

    out[r(i)] = Σ_w vals[i, w] · X[cols[i, w]]
              + Σ_{k ∈ tail(i)} tail_vals[k] · X[tail_cols[k]]

with f32 sums and one rounding.  ``r(i)`` is ``i``, or ``out_rows[i]``
when a target-row map is given; a row whose target is the pad index
``out.shape[0]`` is not written.

The hand-written CUDA kernel (``csrc/spmm_ell.cu``) that replaces the TPU
kernel ``repro.kernels.spmm._spmm_ell``.  The TPU kernel computes the body
only and leaves the tails to a scatter-add; here the row tails are walked
inside the kernel, so a hybrid ELL costs one wrapper call.  It runs
wavefront 1 of both fused kernel arms (written in place into ``D`` at
``j_rows1``) and the whole hybrid product of the unfused arm.  Unlike the
TPU kernel it never stages ``X`` on chip: rows are gathered from device
memory, so any ``X`` fits.

The tails enter as a plan built once on the host (``plan_tails``): each
row's range over the spill lanes, and rows with more than ``max_chunk``
tail entries cut into chunks.  The kernel sums each chunk into an f32
scratch row, and a second pass adds a split row's body and its chunks in
chunk order: the result is the same bits on every run, with no float
atomics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config, ref

#: tail entries one lane group walks at most; longer tails are split
MAX_CHUNK = 256
#: the kernel's record of its dispatch (``spmm_ell_last_path``)
PATHS = {0: "row", 1: "row+split", -1: "none"}


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """Where each row's spill tail lies, on the host (int32).

    ``ranges[i] = (start, end)`` is row ``i``'s tail over the spill lanes,
    or ``(-1, -1)`` for a split row, whose tail lies in ``chunks`` instead:
    ``chunks[k] = (row, start, end)`` with at most ``max_chunk`` entries,
    the chunks of split row ``split_rows[s]`` being
    ``chunks[split_ptr[s]:split_ptr[s + 1]]``, in lane order.  ``order``,
    when set, names the caller's lanes in the plan's lane order (lane ``k``
    of the plan is the caller's lane ``order[k]``; lanes it leaves out are
    not read); None means the caller's lanes as given."""

    ranges: np.ndarray      # (n_rows, 2)
    chunks: np.ndarray      # (n_chunks, 3)
    split_rows: np.ndarray  # (n_split,)
    split_ptr: np.ndarray   # (n_split + 1,)
    order: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class Tails:
    """A ``TailPlan`` and its spill lanes on one device: int32 indices,
    values in the operand dtype."""

    ranges: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    chunks: torch.Tensor
    split_rows: torch.Tensor
    split_ptr: torch.Tensor

    @staticmethod
    def upload(plan: TailPlan, tail_cols, tail_vals, device,
               dtype: torch.dtype) -> "Tails":
        """Copy the plan and its lanes, in the plan's lane order, to
        ``device``; values go through f32 first, as the reference casts
        them."""
        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(device)
        if plan.order is not None:
            tail_cols = np.asarray(tail_cols)[plan.order]
            tail_vals = np.asarray(tail_vals)[plan.order]
        vals = torch.as_tensor(np.asarray(tail_vals, np.float32))
        return Tails(ranges=idx(plan.ranges), cols=idx(tail_cols),
                     vals=vals.to(device, dtype), chunks=idx(plan.chunks),
                     split_rows=idx(plan.split_rows),
                     split_ptr=idx(plan.split_ptr))


def plan_tails(spill_rows, n_rows: int,
               max_chunk: int = MAX_CHUNK) -> TailPlan:
    """The ``TailPlan`` of spill lanes sorted by row (``spill_rows[k]`` is
    the row of lane ``k``, in ``[0, n_rows)``).  Raises on unsorted or
    out-of-range rows: lanes are never re-sorted here."""
    rows = np.asarray(spill_rows, np.int64)
    if max_chunk < 1:
        raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
    if rows.size and (np.any(np.diff(rows) < 0) or rows[0] < 0
                      or rows[-1] >= n_rows):
        raise ValueError("plan_tails: spill lanes must be sorted by row, "
                         f"with rows in [0, {n_rows})")
    ptr = np.searchsorted(rows, np.arange(n_rows + 1))
    starts, ends = ptr[:-1], ptr[1:]
    split = np.flatnonzero(ends - starts > max_chunk)
    ranges = np.stack([starts, ends], axis=1)
    ranges[split] = -1
    n_chunks = -(-(ends[split] - starts[split]) // max_chunk)
    split_ptr = np.concatenate([[0], np.cumsum(n_chunks)])
    owner = np.repeat(np.arange(split.size), n_chunks)
    first = starts[split][owner] + (np.arange(int(split_ptr[-1]))
                                    - split_ptr[:-1][owner]) * max_chunk
    chunks = np.stack([split[owner], first,
                       np.minimum(first + max_chunk, ends[split][owner])],
                      axis=1).reshape(-1, 3)
    return TailPlan(ranges=ranges.astype(np.int32),
                    chunks=chunks.astype(np.int32),
                    split_rows=split.astype(np.int32),
                    split_ptr=split_ptr.astype(np.int32))


def last_path() -> str:
    """What the last launch on the card ran: ``"row"`` (one pass),
    ``"row+split"`` (a second pass for split rows), ``"none"`` before any
    launch or for an empty one (the launcher records its dispatch)."""
    lib = config.kernel_library("cuda")
    return PATHS[lib.spmm_ell_last_path()]


def _check(cols, vals, x, tails, out, out_rows) -> int:
    """Shapes the kernel takes; returns the number of output rows."""
    if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 2:
        raise ValueError(f"spmm_ell: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    n_rows, c = cols.shape[0], x.shape[1]
    if out_rows is not None:
        if out is None:
            raise ValueError("spmm_ell: out_rows needs out")
        if tuple(out_rows.shape) != (n_rows,):
            raise ValueError(f"spmm_ell: out_rows {tuple(out_rows.shape)} "
                             f"for {n_rows} rows")
    if out is not None:
        want = (out.shape[0] if out_rows is not None else n_rows, c)
        if out.dim() != 2 or tuple(out.shape) != want:
            raise ValueError(f"spmm_ell: out {tuple(out.shape)}, expected "
                             f"{want}")
    if tails is not None:
        n_chunks = tails.chunks.shape[0]
        if (tuple(tails.ranges.shape) != (n_rows, 2)
                or tails.cols.dim() != 1
                or tails.vals.shape != tails.cols.shape
                or tuple(tails.chunks.shape) != (n_chunks, 3)
                or tuple(tails.split_ptr.shape)
                != (tails.split_rows.shape[0] + 1,)):
            raise ValueError(
                f"spmm_ell: tails for {n_rows} rows have ranges "
                f"{tuple(tails.ranges.shape)}, cols "
                f"{tuple(tails.cols.shape)}, vals {tuple(tails.vals.shape)},"
                f" chunks {tuple(tails.chunks.shape)}, split_rows "
                f"{tuple(tails.split_rows.shape)}, split_ptr "
                f"{tuple(tails.split_ptr.shape)}")
    return out.shape[0] if out is not None else n_rows


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             tails: Tails | None = None, out: torch.Tensor | None = None,
             out_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The hybrid-ELL product.

    Args:
      cols: ``(n_rows, w)`` int32 body columns (pad slots col 0, val 0).
      vals: ``(n_rows, w)`` in ``x``'s dtype.
      x: ``(n, c)`` f32 or bf16, the gathered table.
      tails: the rows' spill tails (``Tails``), or None for the body only.
      out: write here in place (``(n_rows, c)``, or ``(n_out, c)`` with
        ``out_rows``) instead of a new tensor.
      out_rows: ``(n_rows,)`` int32 target row of each row in ``out``;
        ``out.shape[0]`` marks a pad row, which is not written.
    Returns ``out`` (or the new ``(n_rows, c)`` tensor) in ``x``'s dtype.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel or raise.  One call counts one launch, whatever number of
    device launches it makes."""
    if x.device.type == "cpu":
        _check(cols, vals, x, tails, out, out_rows)
        return ref.spmm_ell(cols, vals, x, tails=tails, out=out,
                            out_rows=out_rows)
    out = launch(config.kernel_library(x.device), cols, vals, x,
                 tails=tails, out=out, out_rows=out_rows)
    spmm_ell.launches += 1
    return out


def launch(lib, cols, vals, x, *, tails=None, out=None, out_rows=None):
    """Check the CUDA tensors and launch ``spmm_ell_launch`` of ``lib``
    (the kernel library, or a build variant of it); returns ``out``."""
    index, values = dict(cols=cols), dict(vals=vals, x=x)
    if tails is not None:
        index.update(tail_ranges=tails.ranges, tail_cols=tails.cols,
                     tail_chunks=tails.chunks,
                     tail_split_rows=tails.split_rows,
                     tail_split_ptr=tails.split_ptr)
        values["tail_vals"] = tails.vals
    if out is not None:
        values["out"] = out
    if out_rows is not None:
        index["out_rows"] = out_rows
    device = config.check_launch(index, values)
    n_out = _check(cols, vals, x, tails, out, out_rows)
    n_rows, w = cols.shape
    c = x.shape[1]
    if out is None:
        out = torch.empty((n_rows, c), dtype=x.dtype, device=device)
    n_chunks = 0 if tails is None else tails.chunks.shape[0]
    partial = (torch.empty((n_chunks, c), dtype=torch.float32, device=device)
               if n_chunks else None)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def tail_ptr(name):
        return 0 if tails is None else getattr(tails, name).data_ptr()

    err = lib.spmm_ell_launch(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
        ptr(out_rows), tail_ptr("ranges"), tail_ptr("cols"),
        tail_ptr("vals"), tail_ptr("chunks"), tail_ptr("split_rows"),
        tail_ptr("split_ptr"), ptr(partial), n_rows, w, c, n_out,
        n_chunks, 0 if tails is None else tails.split_rows.shape[0],
        config.DTYPE_CODES[x.dtype], config.stream_of(device))
    config.raise_on_error(err, "spmm_ell")
    return out


#: wrapper calls that launched the kernel since the count was last set to 0
spmm_ell.launches = 0
