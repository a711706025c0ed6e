"""PyTorch executors for the fused schedule, and the unfused baseline.

Twin of ``repro.core.tilefusion.fused_ops``.  ``fused_gemm_spmm`` /
``fused_spmm_spmm`` are the plain PyTorch fused codes (the paper's
Listing 1 / Listing 3, batched over tiles): the twin of the reference's
``"xla"`` arm, which ``api`` runs as ``backend="torch"``.  ``unfused_*``
are the two-call baselines; each hybrid-ELL product in them (body and spill
tails) is one call of the ``spmm_ell`` kernel wrapper (the kernel on the
card, its plain version on the CPU), as is wavefront 1 of the kernel arms,
written in place into ``D``.  ``index_add_`` of spill lanes remains only on
``backend="torch"`` (``_spill_add``, the twin of the reference's ``.at[]
.add``) and in ``op1_spill``, the dense spill input of the SpMM-SpMM
kernel.

Every executor runs where its operands live.  The schedule's index and
value arrays are uploaded once per ``(device, dtype)`` and memoized on the
(cached) ``DeviceSchedule`` (``schedule_tensors`` / ``op1_tensors``), so a
served request never re-uploads its schedule.  Padded fused-row slots
carry row index ``n_j``: the executors scatter into an ``(n_j + 1)``-row
buffer and drop the last row (PyTorch has no ``mode="drop"`` scatter).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import ops as kops
from ...kernels import ref as kref
from ...kernels import spmm as kspmm
from ..sparse.formats import (CSR, HybridELL, csr_content_digest,
                              ell_slot_coords)
from .schedule import DeviceSchedule


def _ell_rows(cols, vals, table):
    """rows[..., :] = Σ_w vals[..., w] · table[cols[..., w], :], summed slot
    by slot in ``table``'s dtype (the reference's scan over w), so the
    ``(..., w, c)`` gather is never materialized."""
    acc = torch.zeros(cols.shape[:-1] + (table.shape[-1],),
                      dtype=table.dtype, device=table.device)
    for w in range(cols.shape[-1]):
        acc += vals[..., w, None] * table[cols[..., w]]
    return acc


def _spill_add(d, spill_rows, spill_cols, spill_vals, table):
    """Scatter-add COO spill lanes in place: d[r] += v · table[c] per lane
    (the hybrid-ELL tail pass, after the body pass)."""
    if spill_rows.numel():
        d.index_add_(0, spill_rows, spill_vals[:, None] * table[spill_cols])
    return d


def scatter_rows(n_j: int, j_rows: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``(n_j + 1, c)`` buffer with ``rows`` at ``j_rows``; pad slots
    (``j_rows == n_j``) land in the last row, which callers drop."""
    c_col = rows.shape[-1]
    d = torch.zeros((n_j + 1, c_col), dtype=rows.dtype, device=rows.device)
    return d.index_copy_(0, j_rows, rows.reshape(-1, c_col))


# --------------------------------------------------------------------------
# Device copies of a schedule, memoized per (device, dtype)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ScheduleTensors:
    """A ``DeviceSchedule``'s arrays on one device.  The ELL columns are
    int32, as the kernels take them; the int64 copies that the plain
    executors' gathers index with are made on their first use, once."""

    t_pad: int
    cols0: torch.Tensor        # (T0, j0, w0) int32 tile-local
    vals0: torch.Tensor        # (T0, j0, w0) operand dtype
    j_rows0: torch.Tensor      # (T0*j0,) int64, pad n_j
    cols1: torch.Tensor        # (T1*j1, w1) int32 global
    vals1: torch.Tensor        # (T1*j1, w1) operand dtype
    j_rows1: torch.Tensor      # (T1*j1,) int64, pad n_j
    spill_rows1: torch.Tensor  # int64
    spill_cols1: torch.Tensor  # int64
    spill_vals1: torch.Tensor  # operand dtype
    tile_rows: torch.Tensor    # (T0, t_pad) int64 D1 row of each tile slot
    tile_valid: torch.Tensor   # (T0, t_pad) bool, slot < i_len
    #: the host schedule whose wavefront-1 arrays build ``tails1``
    ds: DeviceSchedule = dataclasses.field(repr=False, compare=False)

    @functools.cached_property
    def flat_cols0(self) -> torch.Tensor:
        """(T0, j0, w0) int64 rows of the ``(T0 * t_pad)``-row D1."""
        base = torch.arange(self.cols0.shape[0], device=self.cols0.device)
        return self.cols0.long() + (base * self.t_pad)[:, None, None]

    @functools.cached_property
    def cols1_64(self) -> torch.Tensor:
        return self.cols1.long()

    @functools.cached_property
    def j_rows1_32(self) -> torch.Tensor:
        """The ``spmm_ell`` kernel's int32 target rows of wavefront 1."""
        return self.j_rows1.to(torch.int32)

    @functools.cached_property
    def tails1(self) -> kspmm.Tails:
        """Wavefront 1's spill lanes as the kernel's row tails (in the
        plan's lane order), built and uploaded once."""
        return kspmm.Tails.upload(wf1_tail_plan(self.ds), self.ds.spill_cols1,
                                  self.ds.spill_vals1, self.cols1.device,
                                  self.vals1.dtype)


def wf1_tail_plan(ds: DeviceSchedule,
                  max_chunk: int = kspmm.MAX_CHUNK) -> kspmm.TailPlan:
    """The tail plan of wavefront 1's packed rows (the flat ``j_rows1``):
    spill lanes, keyed by D row, map to their row's packed slot; pad slots
    get empty ranges.

    The kernel takes lanes sorted by slot, and the schedule's lanes need
    not be: headroom lanes (``schedule.pad_device_schedule``) sit at row 0
    with value 0, and an incremental patch moves leaving rows' lanes there
    and writes entering rows' tails into whichever zero lanes come first.
    So the plan carries a canonical lane order (``TailPlan.order``): a
    lane of value 0 whose row has no slot is dropped, a non-zero one
    raises (a schedule fault), and the rest are stable-sorted by slot.
    Where that order is the lanes as given (a schedule straight from
    ``to_device_schedule``), ``order`` is None and the plan is unchanged.
    The ``DeviceSchedule`` arrays themselves are never reordered."""
    return rows_tail_plan(ds.j_rows1, ds.n_j, ds.spill_rows1, ds.spill_vals1,
                          max_chunk)


def rows_tail_plan(j_rows, n_j: int, spill_rows, spill_vals,
                   max_chunk: int = kspmm.MAX_CHUNK) -> kspmm.TailPlan:
    """``wf1_tail_plan`` of any packed row set: ``j_rows`` names each
    packed slot's D row (``n_j`` for a pad slot), and the spill lanes
    ``(spill_rows, spill_vals)`` are keyed by D row (a sharded group's
    wavefront-1 stack and its co-located lanes, whose pad lanes sit at row
    ``n_j`` with value 0)."""
    j_flat = np.asarray(j_rows, np.int64).reshape(-1)
    slot_of = np.full(n_j + 1, -1, np.int64)
    real = np.flatnonzero(j_flat != n_j)
    slot_of[j_flat[real]] = real
    rows = np.asarray(spill_rows, np.int64)
    slots = slot_of[rows]
    orphan = slots < 0
    bad = orphan & (np.asarray(spill_vals) != 0)
    if bad.any():
        raise ValueError(
            f"wf1_tail_plan: {int(bad.sum())} spill lanes of non-zero value "
            f"on rows without a wavefront-1 slot (rows "
            f"{np.unique(rows[bad])[:8].tolist()})")
    keep = np.flatnonzero(~orphan)
    order = keep[np.argsort(slots[keep], kind="stable")]
    plan = kspmm.plan_tails(slots[order], j_flat.size, max_chunk)
    if order.size == rows.size and (order == np.arange(rows.size)).all():
        return plan
    return dataclasses.replace(plan, order=order)


def device_key(device) -> str:
    """A device as a memo key, its index resolved (``"cuda"`` and
    ``"cuda:0"`` are one device and share one upload)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _memo(ds: DeviceSchedule) -> dict:
    memo = getattr(ds, "_tensor_memo", None)
    if memo is None:
        memo = {}
        object.__setattr__(ds, "_tensor_memo", memo)
    return memo


def schedule_tensors(ds: DeviceSchedule, device, dtype) -> ScheduleTensors:
    """The schedule's arrays on ``device`` (values in ``dtype``, cast from
    the schedule's f32 as the reference casts them), uploaded once."""
    key = ("schedule", device_key(device), dtype)
    memo = _memo(ds)
    st = memo.get(key)
    if st is not None:
        return st

    def idx(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(device, dt)

    def val(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device, dtype)

    t1, j1, w1 = ds.ell_cols1.shape
    slot = np.arange(ds.t_pad, dtype=np.int64)
    st = ScheduleTensors(
        t_pad=ds.t_pad,
        cols0=idx(ds.ell_cols0, torch.int32),
        vals0=val(ds.ell_vals0),
        j_rows0=idx(ds.j_rows0.reshape(-1)),
        cols1=idx(ds.ell_cols1.reshape(t1 * j1, w1), torch.int32),
        vals1=val(ds.ell_vals1.reshape(t1 * j1, w1)),
        j_rows1=idx(ds.j_rows1.reshape(-1)),
        spill_rows1=idx(ds.spill_rows1),
        spill_cols1=idx(ds.spill_cols1),
        spill_vals1=val(ds.spill_vals1),
        tile_rows=idx(np.asarray(ds.i_starts, np.int64)[:, None]
                      + slot[None, :]),
        tile_valid=idx(slot[None, :] < np.asarray(ds.i_lens)[:, None],
                       torch.bool),
        ds=ds)
    memo[key] = st
    return st


def _is_uniform(dsched: DeviceSchedule) -> bool:
    """True when wavefront-0 tiles form one uniform grid of stride t_pad
    (the layout the batched fast path and the kernels need).  An empty
    schedule is trivially uniform."""
    t = dsched.t_pad
    st = np.asarray(dsched.i_starts)
    ln = np.asarray(dsched.i_lens)
    if st.size == 0:
        return True
    return bool((st == np.arange(st.shape[0]) * t).all()
                and (ln[:-1] == t).all())


def stitch_d1(ds: DeviceSchedule, st: ScheduleTensors,
              d1_tiles: torch.Tensor) -> torch.Tensor:
    """``(n_i, c)`` D1 from the tiles' ``(T0 * t_pad, c)`` rows: each valid
    slot to its row; padded slots (past a tile's ``i_len``) are dropped,
    never written over the next tile's rows."""
    rows = torch.where(st.tile_valid, st.tile_rows, ds.n_i).reshape(-1)
    d1 = torch.zeros((ds.n_i + 1, d1_tiles.shape[-1]), dtype=d1_tiles.dtype,
                     device=d1_tiles.device)
    return d1.index_copy_(0, rows, d1_tiles)[: ds.n_i]


def _wf1(st: ScheduleTensors, d: torch.Tensor, d1: torch.Tensor, *,
         kernel: bool = False) -> torch.Tensor:
    """Post-barrier wavefront 1 over the finished D1, into ``d`` (``n_j +
    1`` rows, the last one dropped).  The kernel arms make one call of the
    hybrid-ELL kernel wrapper, which writes body plus tail in place at
    ``j_rows1`` (pad slots, index ``n_j``, are not written); the torch arm
    runs the body's plain version, an ``index_copy_`` and the spill lanes'
    scatter-add.  Overwriting ``d`` there is right because wavefront-1 rows
    are disjoint from wavefront 0's."""
    if kernel:
        if st.j_rows1.numel():
            kops.spmm_ell(st.cols1, st.vals1, d1, tails=st.tails1,
                          out=d[: d.shape[0] - 1], out_rows=st.j_rows1_32)
        return d
    if st.j_rows1.numel():
        d.index_copy_(0, st.j_rows1, spmm_ell(st.cols1_64, st.vals1, d1))
    return _spill_add(d, st.spill_rows1, st.spill_cols1, st.spill_vals1, d1)


# --------------------------------------------------------------------------
# Fused executors (tile fusion)
# --------------------------------------------------------------------------
def fused_gemm_spmm(dsched: DeviceSchedule, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """``D = A (B C)`` per the fused schedule, plain PyTorch."""
    ds = dsched
    st = schedule_tensors(ds, c.device, c.dtype)
    n_t, t = ds.n_tiles0, ds.t_pad
    if _is_uniform(ds):
        # one matmul over the padded rows; tile v is rows [v*t, (v+1)*t)
        b_pad = F.pad(b, (0, 0, 0, n_t * t - b.shape[0]))
        d1_tiles = b_pad @ c
        d1 = d1_tiles[: ds.n_i]
    else:
        b_pad = F.pad(b, (0, 0, 0, t))
        d1_tiles = (b_pad[st.tile_rows] @ c).reshape(n_t * t, -1)
        d1 = stitch_d1(ds, st, d1_tiles)
    rows0 = _ell_rows(st.flat_cols0, st.vals0, d1_tiles)
    d = _wf1(st, scatter_rows(ds.n_j, st.j_rows0, rows0), d1)
    return d[: ds.n_j]


def _op1_ell(a1: CSR, dsched: DeviceSchedule, width_cap: int | None = None):
    """Per-tile hybrid ELL of the op-1 rows (global columns into C).

    Routes through the shared ``HybridELL`` packer: the tiles' contiguous
    row ranges are concatenated into one packed row set, the body comes
    back reshaped to ``(T0, t_pad, w)``, and entries past ``width_cap``
    come back as flat spill lanes addressed by *tile-padded* D1 position
    (``tile * t_pad + in_tile_slot``).  Memoized on the (cached)
    DeviceSchedule per op-1 content, as in the reference."""
    memo_key = (csr_content_digest(a1),
                None if width_cap is None else int(width_cap))
    memo = getattr(dsched, "_op1_pack_memo", None)
    if memo is not None and memo[0] == memo_key:
        return memo[1]
    packed = _op1_ell_build(a1, dsched, width_cap)
    object.__setattr__(dsched, "_op1_pack_memo", (memo_key, packed))
    return packed


def _op1_ell_build(a1: CSR, dsched: DeviceSchedule, width_cap: int | None):
    t_pad = dsched.t_pad
    n_t = dsched.n_tiles0
    i_lens = np.asarray(dsched.i_lens, dtype=np.int64)
    w_cap = int(width_cap) if width_cap is not None else None
    if not int(i_lens.sum()):
        w = 1 if w_cap is None else max(min(w_cap, 1), 1)
        return (np.zeros((n_t, t_pad, w), np.int32),
                np.zeros((n_t, t_pad, w), np.float32),
                np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    tile_of, k_of = ell_slot_coords(i_lens)         # ranges concatenated
    rows = np.asarray(dsched.i_starts, np.int64)[tile_of] + k_of
    hell = HybridELL.from_csr_rows(
        a1, rows, cap=w_cap if w_cap is not None else a1.n_cols)
    w = hell.width
    cols = np.zeros((n_t, t_pad, w), np.int32)
    vals = np.zeros((n_t, t_pad, w), np.float32)
    cols[tile_of, k_of] = hell.cols
    vals[tile_of, k_of] = hell.vals.astype(np.float32)
    sr = hell.spill_rows.astype(np.int64)           # packed-row index
    spill_flat = tile_of[sr] * np.int64(t_pad) + k_of[sr]
    return (cols, vals, spill_flat, hell.spill_cols,
            hell.spill_vals.astype(np.float32))


@dataclasses.dataclass
class Op1Tensors:
    """The op-1 pack of one ``a1`` on one device (int64 columns for the
    plain executor made on their first use)."""

    cols: torch.Tensor         # (T0, t_pad, w1) int32 global
    vals: torch.Tensor         # (T0, t_pad, w1) operand dtype
    spill_flat: torch.Tensor   # int64 tile-padded D1 row
    spill_cols: torch.Tensor   # int64
    spill_vals: torch.Tensor   # operand dtype

    @functools.cached_property
    def cols_64(self) -> torch.Tensor:
        return self.cols.long()


def op1_tensors(a1: CSR, ds: DeviceSchedule, device, dtype) -> Op1Tensors:
    """The op-1 pack on ``device``, uploaded once per (a1, cap, device,
    dtype)."""
    key = ("op1", csr_content_digest(a1), ds.width_cap, device_key(device),
           dtype)
    memo = _memo(ds)
    ot = memo.get(key)
    if ot is None:
        cols, vals, spill_flat, spill_cols, spill_vals = _op1_ell(
            a1, ds, width_cap=ds.width_cap)
        as_t = torch.as_tensor
        ot = Op1Tensors(
            cols=as_t(cols).to(device, torch.int32),
            vals=as_t(vals).to(device, dtype),
            spill_flat=as_t(spill_flat).to(device, torch.int64),
            spill_cols=as_t(np.asarray(spill_cols)).to(device, torch.int64),
            spill_vals=as_t(spill_vals).to(device, dtype))
        memo[key] = ot
    return ot


def op1_spill(ot: Op1Tensors, c: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The ``(n_rows, c_col)`` spill delta on the tile-padded D1 rows
    (zeros when nothing spills)."""
    d1_spill = torch.zeros((n_rows, c.shape[1]), dtype=c.dtype,
                           device=c.device)
    return _spill_add(d1_spill, ot.spill_flat, ot.spill_cols, ot.spill_vals,
                      c)


def fused_spmm_spmm(dsched: DeviceSchedule, a1: CSR,
                    c: torch.Tensor) -> torch.Tensor:
    """``D = A (A1 C)`` per the fused schedule, plain PyTorch."""
    ds = dsched
    st = schedule_tensors(ds, c.device, c.dtype)
    ot = op1_tensors(a1, ds, c.device, c.dtype)
    n_rows = ds.n_tiles0 * ds.t_pad
    d1_tiles = (_ell_rows(ot.cols_64, ot.vals, c).reshape(n_rows, -1)
                + op1_spill(ot, c, n_rows))
    rows0 = _ell_rows(st.flat_cols0, st.vals0, d1_tiles)
    d = _wf1(st, scatter_rows(ds.n_j, st.j_rows0, rows0),
             stitch_d1(ds, st, d1_tiles))
    return d[: ds.n_j]


# --------------------------------------------------------------------------
# Unfused baselines (two separate routines, D1 round-trips memory)
# --------------------------------------------------------------------------
def csr_to_ell(a: CSR, width_cap: int | None = None) -> HybridELL:
    """Full-matrix hybrid ELL (the unfused executor's format), on the host;
    ``HybridELL.to_torch`` moves it to a device.  With ``width_cap=None``
    the body is pad-to-max and the spill lanes are empty."""
    return HybridELL.from_csr_rows(
        a, np.arange(a.n_rows),
        cap=width_cap if width_cap is not None else max(a.n_cols, 1))


def spmm_ell(cols, vals, x):
    """Row-ELL SpMM, plain PyTorch: D[i] = Σ_w vals[i,w] · X[cols[i,w]]."""
    return _ell_rows(cols.long(), vals.to(x.dtype), x)


@dataclasses.dataclass(frozen=True)
class HybridTensors:
    """A full-matrix ``HybridELL`` on one device, as the kernel takes it:
    the body (int32 columns) and the spill lanes as row tails."""

    cols: torch.Tensor         # (n_rows, w) int32
    vals: torch.Tensor         # (n_rows, w) operand dtype
    tails: kspmm.Tails

    @staticmethod
    def upload(hell: HybridELL, device, dtype,
               max_chunk: int = kspmm.MAX_CHUNK) -> "HybridTensors":
        """Copy ``hell`` to ``device`` (values through f32, as the
        reference casts them) with its tail plan, built once here."""
        plan = kspmm.plan_tails(hell.spill_rows, hell.cols.shape[0],
                                max_chunk)
        vals = torch.as_tensor(np.asarray(hell.vals, np.float32))
        return HybridTensors(
            cols=torch.as_tensor(np.asarray(hell.cols, np.int32)).to(device),
            vals=vals.to(device, dtype),
            tails=kspmm.Tails.upload(plan, hell.spill_cols, hell.spill_vals,
                                     device, dtype))


def spmm_hybrid(hell: HybridTensors, x, *, kernel: bool = True):
    """Hybrid-ELL SpMM, body and spill tails in one call of the
    ``spmm_ell`` kernel wrapper (the CUDA kernel for CUDA tensors); with
    ``kernel=False`` the kernel's plain version wherever ``x`` lives (the
    torch arm's backward)."""
    if not kernel:
        return kref.spmm_ell(hell.cols, hell.vals, x, tails=hell.tails)
    return kops.spmm_ell(hell.cols, hell.vals, x, tails=hell.tails)


def unfused_gemm_spmm(hell_a: HybridTensors, b, c):
    """``A (B C)``: ``B @ C`` (a plain matmul, outside any kernel in the
    reference too), then the hybrid SpMM."""
    return spmm_hybrid(hell_a, b @ c)


def unfused_spmm_spmm(hell_a: HybridTensors, hell_a1: HybridTensors, c):
    return spmm_hybrid(hell_a, spmm_hybrid(hell_a1, c))
