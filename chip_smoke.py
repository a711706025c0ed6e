#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no exception is caught):

  1. device  — the card's name, power limit and compute capability (9.0+).
  2. build   — the three CUDA kernels from ``src/repro_torch/csrc`` (one
               ``nvcc`` per source, in parallel), with ptxas' register,
               shared-memory and spill report and the build time.
  3. kernels — each kernel against its plain PyTorch version at every
               shape the main path gives it (GCN layers 1 and 2, the
               power-law body, SpMM-SpMM; taken from the real schedules
               below, whose device copies the main path then reuses), f32
               and bf16: max abs / relative error, time (CUDA events), the
               bound (larger of compulsory bytes / 3.35 TB/s and operations
               / peak rate: nonzero entries, needed table rows and real
               output rows, each once; format padding is not counted), the
               plain version's time, and for ``spmm_ell`` the time of
               ``torch.sparse.mm`` as a yardstick.
  4. tile_fused_matmul on ``banded_spd(131072, 8)``, GeMM-SpMM and
               SpMM-SpMM at 128 columns: the ``auto`` pick must be
               ``cuda``; the result must match ``backend="torch"`` on the
               card and the numpy oracle on the host.
  5. GCN serving at the ``CONFIG`` widths (128 → 128 → 32) on two
               131,072-node graphs, 8 requests each: banded (fused arm) and
               power-law (unfused arm).  Each answer is held to the
               ``backend="torch"`` forward.
  6. trace   — one more request per graph under ``torch.profiler``: device
               time by kernel and the device's busy share of the request.

Phases 4 and 5 are the main path: the kernels' launch counts are set to 0
just before phase 4 and read just after phase 5, and every kernel must
have launched there.  The last three lines are the card's
``nvidia-smi`` name and power limit, the kernels' JSON record and the
result line.  float32 matrix products run in true f32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 131_072          # OGB scale (ogbn-arxiv has 169,343 nodes)
REQUESTS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 CUDA cores; bf16 TC
TOL = {"float32": 1e-4, "bfloat16": 2e-2}           # kernel vs plain, rel
MAIN_TOL = 2e-3                                      # path vs references


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(device: str = "cuda") -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.gcn import CONFIG
    from repro_torch.core.sparse.random import banded_spd, powerlaw_graph
    from repro_torch.core.tilefusion import api, fused_ops, fused_ref
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gcn import GCN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    t_start = time.perf_counter()

    # ---- 1. device ----
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 device] nvidia-smi: {smi}")
    print(f"[1 device] {kind}, compute capability {cap[0]}.{cap[1]}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
          f" (CUDA {torch.version.cuda})")
    if cap < (9, 0):
        fail(f"compute capability {cap} < 9.0: the kernels are sm_90a")

    # ---- 2. build ----
    build = _build.build()
    _build.library()
    print(f"[2 build] {build.path.relative_to(ROOT)} in {build.seconds:.1f} s"
          f" (reused: {build.reused})")
    for line in build.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem", "error")):
            print(f"[2 build] {line.strip()}")

    # ---- set-up: graphs, models and their inspections (host) ----
    t0 = time.perf_counter()
    banded = banded_spd(N_NODES, 8, seed=0)
    power = powerlaw_graph(N_NODES, 8, seed=0)
    cfg = dataclasses.replace(CONFIG, n_nodes=N_NODES)
    models = {"banded": GCN(cfg, banded, seed=0, device=dev),
              "powerlaw": GCN(cfg, power, seed=1, device=dev)}
    e_gemm = api.get_schedule(banded, b_col=128, c_col=128)
    e_spmm = api.get_schedule(banded, b_col=128, c_col=128, b_is_sparse=True)
    print(f"[setup] graphs nnz banded={banded.nnz} powerlaw={power.nnz}; "
          f"{api.schedule_cache_stats()['misses']} inspections in "
          f"{time.perf_counter() - t0:.1f} s host")
    for name, e in [("gcn-banded L1", models["banded"].entries[0]),
                    ("gcn-banded L2", models["banded"].entries[1]),
                    ("gcn-powerlaw L1", models["powerlaw"].entries[0]),
                    ("banded gemm", e_gemm), ("banded spmm", e_spmm)]:
        ds = e.dsched
        print(f"[setup] {name}: t={ds.t_pad} T0={ds.n_tiles0} "
              f"j0_max={ds.j_rows0.shape[1]} w0={ds.ell_cols0.shape[2]} "
              f"wf1={tuple(ds.ell_cols1.shape)} "
              f"spill={ds.spill_rows1.size} "
              f"fused_ratio={e.sched.fused_ratio:.3f} "
              f"saving={e.traffic_model['traffic_saving']:.3f} "
              f"inspect={e.inspector_s:.2f}s")

    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * np.float32(scale)
        ).to(dev)

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def rel_err(got, want):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            fail("non-finite values in a result")
        err = float((got - want).abs().max())
        return err, err / max(float(want.abs().max()), 1e-30)

    # ---- 3. kernels against their plain versions ----
    # The bound counts compulsory bytes only: the index and value of each
    # nonzero ELL entry (pad slots hold value 0 and are not needed), the
    # rows of a gathered table that a nonzero names, the output rows that
    # are real (pad rows of a fused-row block, index n_j, are not), and of
    # the SpMM-SpMM spill delta the rows that spill lanes touch.
    def nz_bytes(cols, vals):
        """Bytes of an ELL's nonzero entries: one index and one value."""
        nz = int((vals != 0).sum())
        return float(nz * (cols.element_size() + vals.element_size()))

    def row_bytes(n_rows, table):
        return float(n_rows * table.shape[1] * table.element_size())

    def gathered_bytes(cols, vals, table):
        """The rows of ``table`` a sparse product must read: the distinct
        rows that a nonzero value names (this run's data)."""
        return row_bytes(torch.unique(cols[vals != 0]).numel(), table)

    def real_rows(j_rows, n_j):
        return int((np.asarray(j_rows) != n_j).sum())

    def gemm_case(label, entry, dtype):
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        b_col, c_col = entry.b_col, entry.c_col
        b = randn(ds.n_tiles0 * ds.t_pad, b_col).to(dtype)
        c = randn(b_col, c_col, scale=b_col ** -0.5).to(dtype)
        nnz0 = int((st.vals0 != 0).sum())
        n_ops = 2.0 * ds.n_i * b_col * c_col + 2.0 * nnz0 * c_col
        moved = (nz_bytes(st.cols0, st.vals0) + row_bytes(ds.n_i, b)
                 + row_bytes(b_col, c) + row_bytes(ds.n_i, c)       # d1
                 + row_bytes(real_rows(ds.j_rows0, ds.n_j), c))    # rows0
        return ("tile_fused_gemm_spmm_wf0" + label,
                lambda: ops.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c,
                                                     t=ds.t_pad),
                lambda: ref.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c,
                                                     t=ds.t_pad),
                moved, n_ops, None)

    def wf1_case(label, entry, dtype, library):
        """``spmm_ell`` as wavefront 1 runs it: over the finished D1."""
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        x = randn(ds.n_i, entry.c_col).to(dtype)
        lib = None
        if library:
            keep = st.vals1 != 0
            crow = torch.zeros(st.cols1.shape[0] + 1, dtype=torch.int64,
                               device=dev)
            crow[1:] = torch.cumsum(keep.sum(1), 0)
            csr = torch.sparse_csr_tensor(
                crow, st.cols1.long()[keep], st.vals1[keep],
                (st.cols1.shape[0], ds.n_i), check_invariants=True)
            lib = lambda: torch.sparse.mm(csr, x)   # noqa: E731
        moved = (nz_bytes(st.cols1, st.vals1)
                 + gathered_bytes(st.cols1, st.vals1, x)
                 + row_bytes(real_rows(ds.j_rows1, ds.n_j), x))
        return ("spmm_ell" + label,
                lambda: ops.spmm_ell(st.cols1, st.vals1, x),
                lambda: ref.spmm_ell(st.cols1, st.vals1, x),
                moved, 2.0 * int((st.vals1 != 0).sum()) * x.shape[1], lib)

    def kernel_cases(dtype):
        """(name, kernel call, plain call, compulsory bytes, operations,
        library call or None) at every shape the main path gives each
        kernel: GCN layers 1 and 2, the power-law body, SpMM-SpMM."""
        f32 = dtype == torch.float32
        layer1, layer2 = models["banded"].entries
        yield gemm_case("", layer1, dtype)
        yield gemm_case(" (GCN layer 2)", layer2, dtype)
        yield wf1_case("", layer1, dtype, library=f32)
        yield wf1_case(" (GCN layer 2 wf1)", layer2, dtype, library=False)

        pl = models["powerlaw"]
        hell = api._csr_ell(pl.adj, api._resolve_width_cap(pl.adj, "auto"),
                            dev, dtype)
        x = randn(N_NODES, 128).to(dtype)
        yield ("spmm_ell (power-law unfused body)",
               lambda: ops.spmm_ell(hell[0], hell[1], x),
               lambda: ref.spmm_ell(hell[0], hell[1], x),
               nz_bytes(hell[0], hell[1])
               + gathered_bytes(hell[0], hell[1], x)
               + row_bytes(hell[0].shape[0], x),
               2.0 * int((hell[1] != 0).sum()) * 128, None)

        ds = e_spmm.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        cs = randn(N_NODES, 128, scale=0.1).to(dtype)
        ot = fused_ops.op1_tensors(banded, ds, dev, dtype)
        spill = fused_ops.op1_spill(ot, cs, ds.n_tiles0 * ds.t_pad)
        args = (ot.cols, ot.vals, spill, st.cols0, st.vals0, cs)
        spill_rows = torch.unique(ot.spill_flat).numel()
        ss_ops = (2.0 * int((ot.vals != 0).sum()) * 128 + spill_rows * 128
                  + 2.0 * int((st.vals0 != 0).sum()) * 128)
        moved = (nz_bytes(ot.cols, ot.vals) + row_bytes(spill_rows, spill)
                 + nz_bytes(st.cols0, st.vals0)
                 + gathered_bytes(ot.cols, ot.vals, cs)
                 + row_bytes(ds.n_i, cs)                               # d1
                 + row_bytes(real_rows(ds.j_rows0, ds.n_j), cs))     # rows0
        yield ("tile_fused_spmm_spmm_wf0",
               lambda: ops.tile_fused_spmm_spmm_wf0(*args, t=ds.t_pad),
               lambda: ref.tile_fused_spmm_spmm_wf0(*args, t=ds.t_pad),
               moved, ss_ops, None)

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, kern, plain, moved, n_ops, lib in kernel_cases(dtype):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            bound_bytes = moved / HBM_BYTES_PER_S * 1e3
            bound_ops = n_ops / PEAK_OPS[dname] * 1e3
            ms = time_ms(kern)
            plain_ms = time_ms(plain)
            lib_ms = None
            if lib is not None:
                lib_err = rel_err(lib(), want[0])[1]
                lib_ms = time_ms(lib)
            rec = dict(ms=ms, plain_ms=plain_ms,
                       bound_ms=max(bound_bytes, bound_ops),
                       bound_by="bytes" if bound_bytes >= bound_ops
                       else "operations", library_ms=lib_ms,
                       max_abs_err=abs_err)
            print(f"[3 kernels] {name} {dname}: max_abs={abs_err:.3e} "
                  f"rel={rel:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
                  f" bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                  f"{moved / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop) "
                  f"share={rec['bound_ms'] / ms:.3f}"
                  + (f" torch.sparse.mm={lib_ms:.4f} ms "
                     f"(rel {lib_err:.1e})" if lib_ms is not None else ""))
            if rel > TOL[dname]:
                fail(f"{name} {dname}: rel err {rel:.3e} > {TOL[dname]}")
            records[(name, dname)] = rec

    # ---- 4 + 5: the main path, with the launch counts from 0 ----
    ops.reset_launch_counts()

    # ---- 4. tile_fused_matmul, both op pairs ----
    b_np = rng.standard_normal((N_NODES, 128), np.float32)
    c_np = (rng.standard_normal((128, 128), np.float32)
            / np.float32(128 ** 0.5))
    cs_np = rng.standard_normal((N_NODES, 128), np.float32)
    cases = [("GeMM-SpMM", e_gemm, torch.from_numpy(b_np).to(dev),
              torch.from_numpy(c_np).to(dev),
              lambda: fused_ref.unfused_gemm_spmm(banded, b_np, c_np)),
             ("SpMM-SpMM", e_spmm, banded, torch.from_numpy(cs_np).to(dev),
              lambda: fused_ref.unfused_spmm_spmm(banded, banded, cs_np))]
    for name, entry, b_or_a1, c, oracle in cases:
        pick = api.select_backend(entry, dev)
        if pick != "cuda":
            fail(f"phase 4 {name}: auto picked {pick!r}, expected 'cuda'")
        before = ops.launch_counts()
        t0 = time.perf_counter()
        got = api.tile_fused_matmul(banded, b_or_a1, c)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = api.tile_fused_matmul(banded, b_or_a1, c, backend="torch")
        host = torch.from_numpy(oracle())
        err_t = rel_err(got, want)[1]
        err_h = rel_err(got.cpu().double(), host)[1]
        print(f"[4 tile_fused_matmul] {name}: pick={pick} shape="
              f"{tuple(got.shape)} rel_err vs torch={err_t:.2e} vs host "
              f"oracle={err_h:.2e} launches={launched} wall={wall:.2f} ms")
        if max(err_t, err_h) > MAIN_TOL or got.shape != host.shape:
            fail(f"phase 4 {name}: result disagrees")
        if sum(launched.values()) == 0:
            fail(f"phase 4 {name}: no kernel launched")

    # ---- 5. GCN serving ----
    expected_pick = {"banded": "cuda", "powerlaw": "unfused"}
    serve_p50_ms = {}
    for gname, model in models.items():
        picks = model.layer_backends()
        print(f"[5 gcn] {gname}: layer picks {picks}")
        if picks[0] != expected_pick[gname]:
            fail(f"phase 5 {gname}: layer 1 picked {picks[0]!r}")
        lat, per_req = [], []
        req_rng = np.random.default_rng(100)
        for r in range(REQUESTS):
            x = torch.from_numpy(req_rng.standard_normal(
                (N_NODES, cfg.in_dim), np.float32)).to(dev)
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            per_req.append({k: v - before[k]
                            for k, v in ops.launch_counts().items()})
            want = model(x, backend="torch")
            err = rel_err(logits, want)[1]
            if (tuple(logits.shape) != (N_NODES, cfg.out_dim)
                    or err > MAIN_TOL):
                fail(f"phase 5 {gname} request {r}: shape "
                     f"{tuple(logits.shape)}, rel err {err:.2e}")
        serve_p50_ms[gname] = float(np.median(lat))
        print(f"[5 gcn] {gname}: {REQUESTS} requests, p50="
              f"{float(np.median(lat)):.3f} ms max={max(lat):.3f} ms "
              f"(host clock around forward + synchronize, features already"
              f" on the card); launches per request {per_req[-1]}; "
              f"last rel err vs torch {err:.2e}")

    counts = ops.launch_counts()
    print(f"[main path] kernel launches in phases 4-5: {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # ---- 6. trace: where one request's time goes ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for gname, model in models.items():
        x = torch.from_numpy(np.random.default_rng(200).standard_normal(
            (N_NODES, cfg.in_dim), np.float32)).to(dev)
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched, which would count them twice
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events)
        p50_us = serve_p50_ms[gname] * 1e3
        print(f"[6 trace] {gname}: device busy {device_us / 1e3:.3f} ms per "
              f"request: {device_us / wall_us:.3f} of the profiled wall "
              f"({wall_us / 1e3:.3f} ms), {device_us / p50_us:.3f} of the "
              f"phase-5 p50 ({p50_us / 1e3:.3f} ms)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[6 trace] {gname}:   {e.self_device_time_total:9.1f} us"
                  f"  x{e.count:<3d} {e.key[:90]}")

    sources = {
        "spmm_ell": ("src/repro_torch/csrc/spmm_ell.cu",
                     "src/repro/kernels/spmm.py:40"),
        "tile_fused_gemm_spmm_wf0": (
            "src/repro_torch/csrc/tile_fused_gemm_spmm.cu",
            "src/repro/kernels/tile_fused_gemm_spmm.py:80"),
        "tile_fused_spmm_spmm_wf0": (
            "src/repro_torch/csrc/tile_fused_spmm_spmm.cu",
            "src/repro/kernels/tile_fused_spmm_spmm.py:101"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        rec = records[(name, "float32")]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"],
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"]))
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
