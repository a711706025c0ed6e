"""The port's dry run and roofline against the JAX package's, on the CPU.

- ``roofline``, ``model_flops``, ``_depth_points``, ``dryrun_table`` and
  ``roofline_table`` against ``repro.roofline`` and the reference's
  depth points, on the same inputs (the roofline fraction held to the
  H100's peak instead of the reference's);
- the counted FLOPs of qwen2.5-3b at full width and 2 layers on a 1 × 1
  mesh against XLA's count of the reference's step on a 1 × 1
  ``jax.sharding.Mesh`` (``repro.launch.partitioning.plan`` and
  ``repro.launch.steps``, compiled; not ``repro.launch.dryrun``, which
  forces 512 host devices at import).  XLA's ``cost_analysis()`` also
  counts elementwise ops, and counts the body of a ``while`` loop once:
  at ``decode_32k`` the port is held to XLA's matrix products (its
  ``dot`` ops in the optimized HLO), since the elementwise remainder is
  18 % of XLA's total there (the f32 copies of the repeated 32k caches);
  at ``train_4k`` to XLA's total plus the kv chunks its scan leaves out
  (``chunks_left_out``: each ``lax.scan`` of ``chunked_attention`` runs 4
  chunks and is counted once); at ``prefill_32k`` the flash kernel's
  count is held to a hand count of the kept (query, key) pairs, the rest
  to XLA's products outside the attention loops;
- the ``meta`` run against a real CPU run of the same step, on meshes of
  ``cpu`` entries (1 × 1, (2, 2) and (2, 2, 2) with ``pod``), for a model
  of each block pattern and executor path (``REDUCED``, in f32): FLOPs
  and per-kind collective bytes equal, each member's argument bytes
  equal to the bytes of the blocks the step placed on it, and their sum
  equal to the parameter tree's bytes times each block's replication;
  in a training step each member's peak equal too (in a prefill the
  plain attention standing for the kernel on the CPU allocates more);
- the affine extrapolation from ``_depth_points`` against the full-depth
  count (an ``attn`` and an ``mlstm7+slstm`` config, on ``meta``);
- the five other kernel wrappers raise on ``meta`` tensors, and the flash
  wrapper launches nothing there and charges its kept pairs;
- the report module on JSONs written by ``run_cell`` on a small ``meta``
  mesh.

The reference test's own CLI cell (``--arch hymba-1.5b --shape long_500k
--multi-pod``) counts 512 members for about a minute on this CPU, past
this file's budget: ``chip_smoke.py`` (phase 21) runs that cell on the
single-pod mesh (256 members).
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import roofline as ref_roofline
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.launch import partitioning as RP
from repro.launch import steps as RS
from repro.optim import OptConfig as RefOptConfig
from repro.optim import adamw as ref_adamw
from repro.roofline import report as ref_report
from repro_torch import roofline
from repro_torch.configs import ARCH_NAMES, ShapeConfig, cells, get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, partitioning
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import sharding
from repro_torch.models.sharding import Mesh
from repro_torch.roofline import report
from repro_torch.roofline.analysis import StepCounter


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the models here are small, and several test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, device="meta"):
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    return Mesh(np.full(shape, device, dtype=object), names)


# ------------------------------------------------------ the reference's twins
COSTS = [({"flops": 3.0e14, "bytes accessed": 2.0e12}, {"total_bytes": 5e9}),
         ({"flops": 1.0e9, "bytes accessed": 4.0e12}, {"total_bytes": 0}),
         ({"flops": 0.0, "bytes accessed": 1e6}, {"total_bytes": 1e12})]


@pytest.mark.parametrize("case", range(len(COSTS)))
def test_roofline_matches_reference(case):
    cost, coll = COSTS[case]
    kw = dict(model_flops_global=7.5e16, n_devices=256, peak=PEAK_FLOPS_BF16,
              hbm=HBM_BW)
    ref = ref_roofline.roofline(cost, coll, ici=LINK_BW, **kw).to_dict()
    got = roofline.roofline(cost, coll, link=LINK_BW, **kw).to_dict()
    assert got == ref
    # the defaults are the H100's peaks
    assert roofline.roofline(cost, coll, model_flops_global=7.5e16,
                             n_devices=256).to_dict() == ref


def test_h100_constants():
    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    for mp, shape, axes in ((False, (16, 16), ("data", "model")),
                            (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=mp)
        assert mesh.shape == shape and mesh.axis_names == axes
        assert mesh.device_type == "meta"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_depth_points(arch):
    """``model_flops`` for every shape of ``cells()``, exactly, and the
    depth points of every config."""
    shapes = [s for a, s in cells() if a == arch]
    assert shapes == [s for a, s in ref_cells() if a == arch]
    for s in shapes:
        assert roofline.model_flops(get_config(arch),
                                    partitioning.get_shape(s)) == \
            ref_roofline.model_flops(ref_get_config(arch), ref_get_shape(s))
    # the reference's ``_depth_points`` (its module forces 512 host
    # devices at import, so its rule is restated here)
    ref_points = (8, 16) if ref_get_config(arch).block_pattern == \
        "mlstm7+slstm" else (2, 4)
    assert dryrun._depth_points(get_config(arch)) == ref_points


def _results():
    """Result dicts in the reference's keys, single- and multi-pod."""
    out = []
    for i, (arch, shape) in enumerate([("qwen2.5-3b", "train_4k"),
                                       ("hymba-1.5b", "decode_32k"),
                                       ("xlstm-1.3b", "prefill_32k")]):
        for mp in (False, True):
            r = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if mp else "16x16", "multi_pod": mp,
                 "compile_s": 1.5 + i,
                 "memory_analysis": {"argument_bytes": 3.1e9 * (i + 1),
                                     "output_bytes": 1e6,
                                     "temp_bytes": 2e9,
                                     "peak_bytes": 7.7e9 / (i + 1)}}
            if not mp:
                r["collectives"] = {"bytes": {
                    "all-gather": 1.2e9 * i, "all-reduce": 3.5e8,
                    "reduce-scatter": 0.0, "all-to-all": 0.0,
                    "collective-permute": 2048.0 * i}}
                r["roofline"] = roofline.roofline(
                    {"flops": 1e14 * (i + 1), "bytes accessed": 3e11 / (i + 1)},
                    {"total_bytes": 1e9 * i}, model_flops_global=2e16,
                    n_devices=256).to_dict()
            out.append(r)
    out.append(dict(out[0], memory_analysis=dict(
        out[0]["memory_analysis"], peak_bytes=None)))
    return out


def test_report_tables_match_reference():
    results = _results()
    single = [r for r in results if not r["multi_pod"]]
    assert report.dryrun_table(results) == ref_report.dryrun_table(results)
    assert report.dryrun_table(single) == ref_report.dryrun_table(single)
    assert report.fmt_bytes(3.5e12) == ref_report.fmt_bytes(3.5e12)
    got = report.roofline_table(results).splitlines()
    ref = ref_report.roofline_table(results).splitlines()
    assert len(got) == len(ref) == 2 + len(single)
    assert got[:2] == ref[:2]
    rows = sorted(single, key=lambda x: (x["arch"], x["shape"]))
    for g, f, r in zip(got[2:], ref[2:], rows):
        assert g.split("|")[:-2] == f.split("|")[:-2]
        rl = r["roofline"]
        dom = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        frac = rl["model_flops_per_device"] / PEAK_FLOPS_BF16 / dom
        assert g.split("|")[-2].strip() == f"{frac:.3f}"


# --------------------------------------------------- FLOPs against XLA's ----
QWEN_CUT = {"n_layers": 2}


def _ref_compiled(shape_name):
    """The reference's step of qwen2.5-3b at 2 layers on a 1 × 1 mesh,
    lowered and compiled as its dry run does."""
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    pl = RP.plan("qwen2.5-3b", shape_name, mesh, unroll=True,
                 cfg_replace=QWEN_CUT)
    cfg, rules = pl["cfg"], pl["rules"]
    with mesh:
        if pl["shape"].kind == "train":
            step = RS.make_train_step(cfg, RefOptConfig(), rules)
            opt_abs = jax.eval_shape(ref_adamw.init, pl["params"])
            moments = RP.opt_shardings(pl["param_shardings"], pl["params"],
                                       mesh)
            opt_shard = type(opt_abs)(step=NamedSharding(mesh, JP()),
                                      mu=moments, nu=moments)
            lowered = jax.jit(step, in_shardings=(
                pl["param_shardings"], opt_shard, pl["batch_shardings"]),
            ).lower(pl["params"], opt_abs, pl["batch"])
        elif pl["shape"].kind == "prefill":
            step = RS.make_prefill_step(cfg, rules)
            lowered = jax.jit(step, in_shardings=(
                pl["param_shardings"], pl["batch_shardings"]),
            ).lower(pl["params"], pl["batch"])
        else:
            step = RS.make_serve_step(cfg, rules)
            lowered = jax.jit(step, in_shardings=(
                pl["param_shardings"], pl["batch_shardings"],
                pl["cache_shardings"], NamedSharding(mesh, JP())),
            ).lower(pl["params"], pl["batch"], pl["cache"],
                    jax.ShapeDtypeStruct((), jnp.int32))
        return lowered.compile()


_DEF = re.compile(r"\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*[a-z0-9]+\[([0-9,]*)\]")


def _hlo_dots(text: str) -> tuple:
    """``(dot FLOPs by computation, [(body, known trip count)] of every
    while loop)`` of an optimized HLO module: 2 · the output's elements ·
    the contracted dims of each ``dot``."""
    shapes, dots, loops, comp = {}, {}, [], None
    for line in text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            comp = "ENTRY" if line.startswith("ENTRY") else \
                line.split()[0].lstrip("%")
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
        if " while(" in line:
            body = re.search(r"body=%?([\w.\-]+)", line).group(1)
            trip = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
            loops.append((body, int(trip.group(1))))
        if " dot(" in line and m:
            lhs = re.search(r"dot\(%([\w.\-]+),", line).group(1)
            dims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}",
                             line).group(1)
            n = 2 * int(np.prod(shapes[m.group(1)]))
            for d in dims.split(","):
                n *= shapes[lhs][int(d)]
            dots[comp] = dots.get(comp, 0) + n
    return dots, loops


def _port_flops(shape_name):
    return dryrun._count("qwen2.5-3b", shape_name, _mesh((1, 1)),
                         cfg_replace=QWEN_CUT)["cost"]["flops"]


@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k",
                                        "prefill_32k"])
def test_flops_against_xla(shape_name):
    compiled = _ref_compiled(shape_name)
    xla = compiled.cost_analysis()["flops"]
    dots, loops = _hlo_dots(compiled.as_text())
    port = _port_flops(shape_name)
    if shape_name == "decode_32k":
        # both sides run the same plain attention; no loop
        assert not loops
        assert port == pytest.approx(sum(dots.values()), rel=0.02)
        elementwise = xla - sum(dots.values())
        assert 0 < elementwise < 0.25 * xla
    elif shape_name == "train_4k":
        # every loop is a kv-chunk scan of chunked_attention: 4096 / 1024
        # chunks, each counted once by XLA
        assert loops and all(n == 4 for _, n in loops)
        chunks_left_out = sum((n - 1) * dots.get(body, 0) for body, n in loops)
        assert port == pytest.approx(xla + chunks_left_out, rel=0.02)
        # the products alone agree closer
        assert port == pytest.approx(sum(dots.values()) + chunks_left_out,
                                     rel=1e-3)
    else:
        # the flash kernel charges the pairs its causal mask keeps; the
        # reference's plain path scans all 32 chunks, the masked half too
        cfg, s = get_config("qwen2.5-3b"), 32768
        pairs = s * (s + 1) // 2
        assert FA.kept_pairs(s, s, True, 0) == pairs
        attention = QWEN_CUT["n_layers"] * 4 * cfg.head_dim * 32 * \
            cfg.n_heads * pairs
        outside = sum(n for comp, n in dots.items()
                      if comp not in {b for b, _ in loops})
        assert port == pytest.approx(outside + attention, rel=0.02)


# ------------------------------------------------ meta against the CPU ----
#: a model of each block pattern and executor path: dense GQA (the
#: tensor-parallel blocks), MoE, MLA, the hybrid, xLSTM, the
#: encoder-decoder
META_MODELS = ["qwen2.5-3b", "granite-moe-3b-a800m", "minicpm3-4b",
               "hymba-1.5b", "xlstm-1.3b", "whisper-medium"]
SMALL = [ShapeConfig("small_train", 8, 4, "train"),
         ShapeConfig("small_prefill", 8, 4, "prefill"),
         ShapeConfig("small_decode", 8, 4, "decode")]


def _reduced(arch):
    """The arch's ``REDUCED`` config in f32; xLSTM's heads narrowed from
    the 512 its ``REDUCED`` config keeps to ``d_model / n_heads``."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    if cfg.block_pattern == "mlstm7+slstm":
        dh = cfg.d_model // cfg.n_heads
        cfg = dataclasses.replace(cfg, head_dim=dh, ssm_head_dim=dh)
    return dataclasses.asdict(cfg)


def _shard_bytes(pl_, who):
    """The bytes of member ``who``'s batch shard, as the executor slices
    it (every row where the batch does not divide)."""
    mem = sharding.Members(pl_["rules"])
    out = 0
    for t in pl_["batch"].values():
        rows = mem.rows(t.shape[0])[who[0]]
        out += (rows.stop - rows.start) * t[0].numel() * t.element_size()
    return out


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch", META_MODELS)
def test_meta_run_matches_cpu_run(arch, mesh_shape):
    for shape in SMALL:
        got = {dev: dryrun._count(arch, shape, _mesh(mesh_shape, dev),
                                  cfg_replace=_reduced(arch))
               for dev in ("meta", "cpu")}
        meta, cpu = got["meta"], got["cpu"]
        assert meta["cost"]["flops"] == cpu["cost"]["flops"] > 0
        assert meta["coll"] == cpu["coll"]
        if shape.kind == "train":
            # no plain version stands in for a kernel there: the cached
            # meta outputs take the real ones' storage, member by member
            assert {w: m["peak_bytes"] for w, m in meta["members"].items()} \
                == {w: m["peak_bytes"] for w, m in cpu["members"].items()}
        if mesh_shape != (1, 1):
            assert cpu["coll"]["total_bytes"] > 0
        pl_ = meta["plan"]
        n_dev = int(np.prod(mesh_shape))
        for run in (meta, cpu):
            assert len(run["members"]) == n_dev
            for who, m in run["members"].items():
                placed = sum(t.numel() * t.element_size()
                             for t in run["blocks"].get(who, []))
                assert m["argument_bytes"] == placed + \
                    _shard_bytes(pl_, who), (shape.kind, who)
                assert m["peak_bytes"] >= m["argument_bytes"]
            assert {w: m["argument_bytes"] for w, m in
                    run["members"].items()} == \
                {w: m["argument_bytes"] for w, m in meta["members"].items()}
        # the parameter blocks over all members: each leaf's bytes times
        # its replication
        sizes = sharding.axis_sizes(pl_["rules"].mesh)
        leaves = dryrun.T._flatten(pl_["params"])
        specs = dryrun.T._flatten(pl_["param_shardings"])
        want = 0
        for leaf, spec in zip(leaves, specs):
            split = int(np.prod([sizes[a] for ax in spec if ax is not None
                                 for a in (ax if isinstance(ax, tuple)
                                           else (ax,))]))
            want += leaf.numel() * leaf.element_size() * (n_dev // split)
        mem = sharding.Members(pl_["rules"])
        assert sum(dryrun._blocks(pl_["params"], pl_["param_shardings"],
                                  mem).values()) == want


@pytest.mark.parametrize("arch,depth", [("qwen2.5-3b", 7),
                                        ("xlstm-1.3b", 24)])
def test_depth_extrapolation(arch, depth):
    """The reference's affine extrapolation from the two shallow depths
    gives the full-depth count exactly: every layer is counted."""
    base = dict(_reduced(arch), n_layers=depth)
    cfg = get_config(arch)
    k1, k2 = dryrun._depth_points(cfg)
    shape = ShapeConfig("small_train", 8, 4, "train")

    def flops(n):
        return dryrun._count(arch, shape, _mesh((2, 2)),
                             cfg_replace=dict(base, n_layers=n))[
                                 "cost"]["flops"]
    y1, y2, full = flops(k1), flops(k2), flops(depth)
    assert y2 > y1
    assert y2 + (y2 - y1) / (k2 - k1) * (depth - k2) == pytest.approx(
        full, rel=1e-12)


# ------------------------------------------------------------ the wrappers --
def test_kernel_wrappers_on_meta():
    """The five wrappers off the LM cells' path refuse ``meta`` tensors
    (their kernels take CUDA tensors); flash attention returns an empty
    output, launches nothing and charges its kept pairs."""
    meta = dict(device="meta")
    x = torch.empty(64, 32, **meta)
    cols = torch.empty(2, 8, 4, dtype=torch.int32, **meta)
    vals = torch.empty(2, 8, 4, **meta)
    calls = [
        lambda: ops.fused_ffn(x, torch.empty(32, 64, **meta),
                              torch.empty(64, 32, **meta)),
        lambda: ops.fused_moe_ffn(torch.empty(4, 16, 32, **meta),
                                  torch.empty(4, 32, 64, **meta),
                                  torch.empty(4, 64, 32, **meta)),
        lambda: ops.spmm_ell(cols[0], vals[0], x),
        lambda: ops.tile_fused_gemm_spmm_wf0(cols, vals, x,
                                             torch.empty(32, 16, **meta),
                                             t=32),
        lambda: ops.tile_fused_spmm_spmm_wf0(
            torch.empty(2, 32, 4, dtype=torch.int32, **meta),
            torch.empty(2, 32, 4, **meta), x, cols, vals, x, t=32),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    ops.reset_launch_counts()
    b, h, hkv, s, d = 2, 4, 2, 96, 16
    q = torch.empty(b, h, s, d, dtype=torch.bfloat16, **meta)
    k = torch.empty(b, hkv, s, d, dtype=torch.bfloat16, **meta)
    with StepCounter() as counter:
        out = ops.flash_attention(q, k, k, causal=True, window=32)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert ops.launch_counts()["flash_attention"] == 0
    pairs = sum(1 for i in range(s) for j in range(s) if j <= i and
                i - j < 32)
    assert counter.flops == 4 * d * b * h * pairs
    assert counter.bytes == (2 * q.numel() + 2 * k.numel()) * 2
    # outside a dry run nothing is charged and nothing launches
    assert ops.flash_attention(q, k, k).is_meta
    assert ops.launch_counts()["flash_attention"] == 0


def test_run_cell_and_report(tmp_path, capsys):
    """``run_cell`` on a small ``meta`` mesh writes the reference's keys,
    and the report reads them."""
    res = dryrun.run_cell("hymba-1.5b", "long_500k", mesh=_mesh((2, 2)),
                          cfg_replace={"n_layers": 2}, verbose=False)
    assert res["n_devices"] == 4 and res["mesh"] == "2x2"
    assert res["memory_analysis"]["peak_bytes"] >= \
        res["memory_analysis"]["argument_bytes"] > 0
    assert res["depth_counted"] == 2
    assert set(res["collectives"]["bytes"]) == set(
        ref_roofline.analysis._COLLECTIVES)
    assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                              "collective")
    multi = dict(res, multi_pod=True, mesh="2x2x1")
    for name, r in (("a", res), ("b", multi)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(r, f)
    loaded = report.load(str(tmp_path))
    assert len(loaded) == 2
    import sys
    argv = sys.argv
    sys.argv = ["report", str(tmp_path)]
    try:
        report.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "H100" in out and "hymba-1.5b" in out and "2x2x1" in out
