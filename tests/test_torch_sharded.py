"""The port's sharded tile fusion against the JAX package's, on the CPU.

A twin of ``tests/test_sharded.py`` and ``tests/test_sharded_properties.py``
at their sizes (``p=2, cache_size=30_000, ct_size=32``; 64- and 96-node
patterns):

- the partition helpers (``balanced_contiguous_partition``,
  ``resolve_mesh_layout``, ``balanced_mesh_partition``) and the
  communication model (``shard_comm_model``, ``choose_mesh_layout``) equal
  the reference's;
- ``ShardedSchedule`` array for array against the reference's builder over
  {banded, powerlaw-hub, empty-rows} × meshes (8,) 1d, (4, 2) 1.5d,
  (2, 2, 2) 2.5d × both combines × overlap (the builder is numpy, so the
  reference needs no devices);
- execution on meshes of eight ``cpu`` entries (the port's counterpart of
  the forced host platform) against ``fused_ref`` (2e-3) and the port's
  single-device ``"torch"`` arm, overlap equal to sync within 1e-6 (the
  reference's bar, ``test_sharded_properties.py::test_overlap_equals_sync``);
- gradients against ``jax.grad`` of the reference's single-device product,
  ``GCN.forward`` / ``loss`` and a train step with ``mesh=`` against the
  reference's ``GCN``, ``hetero_fused_matmul`` under a mesh, the serving
  tier's bail on a mesh entry, the cache keys and counters, and
  ``backend="sharded"`` without a partitioned entry;
- one subprocess cell runs the reference's own sharded executor on a
  forced 8-device host platform and holds the port's outputs to it.
"""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port, pattern_pair
from repro.configs.gcn import GCNConfig as RefGCNConfig
from repro.core.sparse.random import hub_powerlaw as ref_hub_powerlaw
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import cost_model as ref_cost
from repro.core.tilefusion import hetero as ref_hetero
from repro.core.tilefusion import scheduler as ref_scheduler
from repro.core.tilefusion import sharded as ref_sharded
from repro.launch.steps import make_gcn_train_step as ref_train_step
from repro.models.gcn import GCN as RefGCN
from repro_torch.configs.gcn import GCNConfig
from repro_torch.core.sparse.random import induced_subgraph, perturb_rows
from repro_torch.core.tilefusion import (api, cost_model, fused_ops,
                                         fused_ref, hetero, scheduler,
                                         serving, sharded)
from repro_torch.launch.steps import make_gcn_train_step
from repro_torch.models import sharding
from repro_torch.models.gcn import GCN
from repro_torch.models.sharding import Mesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name here -> the shared cell of test_torch_cells
PATTERNS = {"banded": "banded", "powerlaw-hub": "single-hub-row",
            "empty-rows": "empty-rows"}
#: (mesh shape, layout) of the three rungs
MESHES = {"1d": ((8,), "1d"), "1.5d": ((4, 2), "1.5d"),
          "2.5d": ((2, 2, 2), "2.5d")}
COMBINES = ("psum", "reduce_scatter")
TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.clear_schedule_cache()
    yield
    api.clear_schedule_cache()


def cpu_mesh(shape) -> Mesh:
    """A mesh of ``cpu`` entries: every shard runs on the CPU."""
    return Mesh(np.full(shape, "cpu", dtype=object),
                ("x", "y", "z", "w")[:len(shape)])


def _spec(mesh_name: str, combine="auto", overlap=False, **kw):
    shape, layout = MESHES[mesh_name]
    return api.FusionSpec(**KNOBS, mesh=cpu_mesh(shape), shard_layout=layout,
                          shard_combine=combine, overlap=overlap, **kw)


def _operands(op_pair: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if op_pair == "spmm":
        return None, rng.standard_normal((n, 8))
    return rng.standard_normal((n, 8)), rng.standard_normal((8, 8))


def _run(ta, op_pair, b, c, spec, backend="sharded"):
    tc = torch.as_tensor(c, dtype=torch.float32)
    tb = ta if op_pair == "spmm" else torch.as_tensor(b, dtype=torch.float32)
    return api.tile_fused_matmul(ta, tb, tc, backend=backend, spec=spec)


def _oracle(ra, op_pair, b, c):
    if op_pair == "spmm":
        return fused_ref.unfused_spmm_spmm(as_port(ra), as_port(ra), c)
    return fused_ref.unfused_gemm_spmm(as_port(ra), b, c)


# --------------------------------------------------------------------------
# Partition helpers and the communication model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_parts", [1, 3, 4, 8, 13])
@pytest.mark.parametrize("seed", range(3))
def test_balanced_partition_equals_the_reference(seed, n_parts):
    rng = np.random.default_rng(seed)
    for n in (0, 2, 9, 40):
        costs = rng.gamma(2.0, 5.0, n)
        np.testing.assert_array_equal(
            scheduler.balanced_contiguous_partition(costs, n_parts),
            ref_scheduler.balanced_contiguous_partition(costs, n_parts))


@pytest.mark.parametrize("layout", ["1d", "1.5d", "2.5d"])
def test_mesh_layouts_equal_the_reference(layout):
    costs = np.random.default_rng(1).gamma(2.0, 5.0, 24)
    for shape in [(8,), (4, 2), (2, 4), (2, 2, 2), (2, 1, 4), (3, 2, 2, 2),
                  (1,), (1, 8)]:
        assert (scheduler.resolve_mesh_layout(shape, layout)
                == ref_scheduler.resolve_mesh_layout(shape, layout))
        got = scheduler.balanced_mesh_partition(costs, shape, layout)
        want = ref_scheduler.balanced_mesh_partition(costs, shape, layout)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        # the executor's grid folds the same axes
        assert cpu_mesh(shape).grid(layout).shape == \
            scheduler.resolve_mesh_layout(shape, layout)
    with pytest.raises(ValueError):
        scheduler.resolve_mesh_layout((4, 2), "3d")


@pytest.mark.parametrize("overlap", [False, True, "auto"])
def test_comm_model_equals_the_reference(overlap):
    for s, r, z, h, wf0 in [(8, 1, 1, 40, 0.0), (4, 2, 1, 200, 1e5),
                            (2, 2, 2, 7, 3e6), (1, 1, 1, 0, 0.0)]:
        kw = dict(dtype_bytes=4, n_j=96, n_repl=r, combine_rows=100,
                  n_depth=z, overlap=overlap, wf0_bytes=wf0)
        assert (cost_model.shard_comm_model(s, h, 96, 8, **kw)
                == ref_cost.shard_comm_model(s, h, 96, 8, **kw))
    for shape in [(8,), (4, 2), (2, 2, 2)]:
        for serial in (0.0, 5e4, 5e7):
            kw = dict(halo_rows=300, n_i=4096, n_j=4096, c_col=64,
                      operand_bytes=2e5, serial_bytes=serial,
                      overlap=overlap, wf0_bytes=serial / 3)
            assert (cost_model.choose_mesh_layout(shape, **kw)
                    == ref_cost.choose_mesh_layout(shape, **kw))


def test_mesh_key_and_axes_follow_the_reference():
    for shape in [(1,), (8,), (4, 2), (2, 2, 2)]:
        mesh = cpu_mesh(shape)
        stand_in = types.SimpleNamespace(devices=np.empty(shape),
                                         axis_names=mesh.axis_names)
        assert sharded.mesh_key(mesh) == ref_sharded.mesh_key(stand_in)
        for layout in ("1d", "1.5d", "2.5d"):
            assert (sharding.mesh_row_repl_axes(mesh, layout)
                    == _ref_row_repl_axes(stand_in, layout))
    assert sharded.mesh_key(None) is None


def _ref_row_repl_axes(mesh, layout):
    from repro.models.sharding import mesh_row_repl_axes
    return mesh_row_repl_axes(mesh, layout)


def test_mesh_checks_its_devices():
    mesh = Mesh([["cpu", "cpu"], ["cpu", torch.device("cpu")]], ("x", "y"))
    assert mesh.shape == (2, 2) and mesh.device_type == "cpu"
    assert all(isinstance(d, torch.device) for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("x", "y"))
    with pytest.raises(ValueError, match="one device type"):
        Mesh(["cpu", "meta"], ("x",))


# --------------------------------------------------------------------------
# ShardedSchedule array for array
# --------------------------------------------------------------------------
def _assert_same_schedule(got, want):
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, field.name
            np.testing.assert_array_equal(g, w, err_msg=field.name)
        else:
            assert g == w, field.name


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_sharded_schedule_equals_the_reference(pattern, mesh_name, combine,
                                               overlap):
    """The port's mesh entry (through ``get_schedule``, so
    ``_shard_for_mesh`` too) against the reference's builder on the
    reference's own inspection; SpMM-SpMM on the powerlaw-hub cells."""
    ra, ta = pattern_pair(PATTERNS[pattern], seed=3)
    spmm = pattern == "powerlaw-hub"
    shape, layout = MESHES[mesh_name]
    ref_entry = ref_api.get_schedule(ra, b_col=8, c_col=8, b_is_sparse=spmm,
                                     spec=ref_api.FusionSpec(**KNOBS))
    want = ref_sharded.build_sharded_schedule(
        ra, ref_entry.sched, ref_entry.dsched, shape, b_col=8, c_col=8,
        b_is_sparse=spmm, width_cap=ref_entry.width_cap, layout=layout,
        combine=combine, overlap=overlap)
    entry = api.get_schedule(ta, b_col=8, c_col=8, b_is_sparse=spmm,
                             spec=_spec(mesh_name, combine, overlap))
    _assert_same_schedule(entry.shard, want)
    assert entry.shard.layout == layout
    assert entry.traffic_model["sharded"] == want.comm_model
    assert entry.mesh_key == ref_sharded.mesh_key(types.SimpleNamespace(
        devices=np.empty(shape), axis_names=("x", "y", "z")[:len(shape)]))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_auto_layout_and_combine_equal_the_reference(mesh_name):
    """``shard_layout`` / ``shard_combine`` / ``overlap`` all ``"auto"``:
    the reference's ``_shard_for_mesh`` picks the same partition."""
    ra, ta = pattern_pair("powerlaw", seed=2)
    shape, _ = MESHES[mesh_name]
    ref_entry = ref_api.get_schedule(ra, b_col=8, c_col=8,
                                     spec=ref_api.FusionSpec(**KNOBS))
    mk = ref_sharded.mesh_key(types.SimpleNamespace(
        devices=np.empty(shape), axis_names=("x", "y", "z")[:len(shape)]))
    want = ref_api._shard_for_mesh(
        ra, ref_entry.sched, ref_entry.dsched, mk, b_col=8, c_col=8,
        b_is_sparse=False, width_cap=ref_entry.width_cap,
        shard_combine="auto", shard_layout="auto", overlap="auto",
        serial_bytes=ref_entry.traffic_model["fused_bytes"])
    spec = api.FusionSpec(**KNOBS, mesh=cpu_mesh(shape))
    got = api.get_schedule(ta, b_col=8, c_col=8, spec=spec).shard
    if want is None:
        assert got is None
    else:
        _assert_same_schedule(got, want)


def test_non_uniform_schedule_does_not_shard():
    from repro.core.sparse.random import banded_spd
    ra = banded_spd(96, 4, seed=1)        # tiles of 8 and 16 rows here
    ta = as_port(ra)
    kw = dict(p=2, cache_size=2_000.0, ct_size=32, uniform_split=False)
    entry = api.get_schedule(ta, b_col=8, c_col=8, spec=api.FusionSpec(
        **kw, mesh=cpu_mesh((4,))))
    ref_entry = ref_api.get_schedule(ra, b_col=8, c_col=8,
                                     spec=ref_api.FusionSpec(**kw))
    want = ref_sharded.build_sharded_schedule(
        ra, ref_entry.sched, ref_entry.dsched, 4, b_col=8, c_col=8,
        b_is_sparse=False, width_cap=ref_entry.width_cap)
    assert not fused_ops._is_uniform(entry.dsched)
    assert entry.shard is None and want is None
    assert entry.mesh_key is not None
    assert api.schedule_cache_stats()["layout_fallback"] == 1
    b, c = _operands("gemm", 96, 0)
    got = _run(ta, "gemm", b, c, api.FusionSpec(**kw, mesh=cpu_mesh((4,))))
    np.testing.assert_allclose(got.numpy(), _oracle(ra, "gemm", b, c),
                               rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# Execution on meshes of cpu entries
# --------------------------------------------------------------------------
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_sharded_matches_oracle_and_torch_arm(op_pair, pattern, mesh_name,
                                              combine):
    ra, ta = pattern_pair(PATTERNS[pattern], seed=3)
    b, c = _operands(op_pair, ta.n_rows, seed=11)
    want = _oracle(ra, op_pair, b, c)
    plain = _run(ta, op_pair, b, c, api.FusionSpec(**KNOBS), backend="torch")
    outs = {}
    for overlap in (False, True):
        spec = _spec(mesh_name, combine, overlap)
        for backend in ("sharded", "auto"):
            got = _run(ta, op_pair, b, c, spec, backend=backend)
            assert got.shape == want.shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
            torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)
        outs[overlap] = got
        entry = api.get_schedule(
            ta, b_col=8, c_col=8, b_is_sparse=op_pair == "spmm",
            spec=dataclasses.replace(spec, dtype_bytes=4))
        assert api.select_backend(entry, "cpu") == "sharded"
        assert entry.shard.overlap == (overlap and entry.shard.halo_size > 0)
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_ragged_columns_pad_for_the_replicas(op_pair):
    """C's 7 columns over 2 replicas (1.5d) and 2 x 2 (2.5d): padded to a
    multiple, sliced back off."""
    ra, ta = pattern_pair("powerlaw", seed=4)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((64, 8))
    c = rng.standard_normal((64 if op_pair == "spmm" else 8, 7))
    want = _oracle(ra, op_pair, b, c)
    for mesh_name in ("1.5d", "2.5d"):
        got = _run(ta, op_pair, b, c, _spec(mesh_name, "reduce_scatter"))
        assert got.shape == (64, 7)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_collectives_count_the_bytes_between_shards():
    """The halo gather moves (S - 1) parts per member per fiber, the psum
    2 (S - 1) partials per group, the owner blocks all but the consumer's
    one; and the counts sit beside the model's terms."""
    ra, ta = pattern_pair("single-hub-row", seed=3)
    b, c = _operands("gemm", 64, 0)
    for combine in COMBINES:
        spec = _spec("1d", combine)
        entry = api.get_schedule(ta, b_col=8, c_col=8,
                                 spec=dataclasses.replace(spec,
                                                          dtype_bytes=4))
        sh = entry.shard
        sharding.reset_comm_bytes()
        _run(ta, "gemm", b, c, spec)
        counted = dict(sharding.comm_bytes)
        s_n = sh.n_shards
        assert counted["all_gather"] == (s_n - 1) * s_n \
            * sh.send_per_shard * 8 * 4
        if combine == "psum":
            assert counted["psum"] == 2 * (s_n - 1) * sh.n_j * 8 * 4
            assert counted["gather"] == 0
        else:
            assert counted["psum"] == 0
            assert counted["gather"] == (s_n - 1) * sh.rows_per_shard * 8 * 4
        # the padded send tables never move fewer bytes than the model's
        assert counted["all_gather"] >= sh.comm_model["halo_bytes"]


def test_mesh_of_another_device_type_raises():
    _, ta = pattern_pair("banded")
    spec = api.FusionSpec(**KNOBS, mesh=Mesh(["meta"] * 4, ("x",)))
    with pytest.raises(ValueError, match="mesh holds meta"):
        api.tile_fused_matmul(ta, torch.randn(64, 8), torch.randn(8, 4),
                              spec=spec)
    with pytest.raises(TypeError, match="Mesh"):
        api.get_schedule(ta, b_col=8, c_col=4,
                         spec=api.FusionSpec(**KNOBS, mesh=object()))


def test_sharded_backend_without_a_shard_runs_the_torch_arm():
    """``backend="sharded"`` on an entry with no partition (no mesh, or a
    one-device mesh) takes the single-device pick: ``"torch"`` on CPU
    tensors, bit for bit."""
    _, ta = pattern_pair("banded")
    b, c = _operands("gemm", 64, 0)
    want = _run(ta, "gemm", b, c, api.FusionSpec(**KNOBS), backend="torch")
    for spec in (api.FusionSpec(**KNOBS),
                 api.FusionSpec(**KNOBS, mesh=cpu_mesh((1,)))):
        got = _run(ta, "gemm", b, c, spec, backend="sharded")
        assert torch.equal(got, want)
    entry = api.get_schedule(ta, b_col=8, c_col=8, spec=api.FusionSpec(
        **KNOBS, mesh=cpu_mesh((1,))))
    assert entry.shard is None and entry.mesh_key is None
    assert api.select_backend(entry, "cpu") == "torch"


# --------------------------------------------------------------------------
# Cache keys and counters
# --------------------------------------------------------------------------
def test_mesh_shape_keys_the_schedule_cache():
    _, ta = pattern_pair("banded")
    plain = api.get_schedule(ta, b_col=8, c_col=8,
                             spec=api.FusionSpec(**KNOBS))
    stats = api.schedule_cache_stats()
    assert stats["misses"] == 1 and stats["mesh_entries"] == 0
    # a trivial mesh keys exactly like no mesh, whatever its inert knobs
    one = api.FusionSpec(**KNOBS, mesh=cpu_mesh((1,)), overlap=True,
                         shard_combine="psum")
    assert api.get_schedule(ta, b_col=8, c_col=8, spec=one) is plain
    assert api.schedule_cache_stats()["misses"] == 1
    mesh_spec = api.FusionSpec(**KNOBS, mesh=cpu_mesh((8,)))
    e8 = api.get_schedule(ta, b_col=8, c_col=8, spec=mesh_spec)
    assert e8 is not plain and e8.shard is not None
    assert e8.sched is plain.sched and e8.dsched is plain.dsched
    stats = api.schedule_cache_stats()
    assert stats["misses"] == 2 and stats["mesh_entries"] == 1
    # the same shape over another Mesh object: a hit
    again = api.FusionSpec(**KNOBS, mesh=cpu_mesh((8,)))
    assert api.get_schedule(ta, b_col=8, c_col=8, spec=again) is e8
    # a new shape over the same devices: a miss
    e42 = api.get_schedule(ta, b_col=8, c_col=8, spec=api.FusionSpec(
        **KNOBS, mesh=cpu_mesh((4, 2)), shard_layout="1.5d"))
    e222 = api.get_schedule(ta, b_col=8, c_col=8, spec=api.FusionSpec(
        **KNOBS, mesh=cpu_mesh((2, 2, 2)), shard_layout="2.5d"))
    assert len({id(e) for e in (e8, e42, e222)}) == 3
    stats = api.schedule_cache_stats()
    assert stats["misses"] == 4 and stats["mesh_entries"] == 3
    assert (e8.shard.layout, e42.shard.layout,
            e222.shard.layout) == ("1d", "1.5d", "2.5d")
    assert (stats["layout_1d"], stats["layout_15d"],
            stats["layout_25d"]) == (1, 1, 1)
    with pytest.raises(ValueError, match="shard_layout"):
        api.get_schedule(ta, b_col=8, c_col=8, spec=dataclasses.replace(
            mesh_spec, shard_layout="3d"))
    with pytest.raises(ValueError, match="shard_combine"):
        api.get_schedule(ta, b_col=8, c_col=8, spec=dataclasses.replace(
            mesh_spec, shard_combine="allreduce"))


def test_bucket_with_a_mesh_raises_as_the_reference():
    ra, ta = pattern_pair("banded")
    with pytest.raises(ValueError, match="single-device"):
        api.get_schedule(ta, b_col=8, c_col=8, spec=api.FusionSpec(
            **KNOBS, bucket=(64, 64, None), mesh=cpu_mesh((2,))))
    stand_in = types.SimpleNamespace(devices=np.empty((2,)),
                                     axis_names=("x",))
    with pytest.raises(ValueError, match="single-device"):
        ref_api.get_schedule(ra, b_col=8, c_col=8, spec=ref_api.FusionSpec(
            **KNOBS, bucket=(64, 64, None), mesh=stand_in))


def test_autotune_and_reorder_compose_with_a_mesh():
    """The winner of the sweep and a baked ordering are sharded like any
    entry; the results still match the oracle."""
    ra, ta = pattern_pair("banded", seed=2)
    b, c = _operands("gemm", 64, 5)
    want = _oracle(ra, "gemm", b, c)
    for kw in (dict(autotune=True), dict(reorder="rcm")):
        spec = _spec("1d", "reduce_scatter", **kw)
        got = _run(ta, "gemm", b, c, spec, backend="auto")
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        entry = api.get_schedule(ta, b_col=8, c_col=8, spec=dataclasses
                                 .replace(spec, dtype_bytes=4))
        assert entry.shard is not None
        assert (entry.autotuned is not None if "autotune" in kw
                else entry.reorder == "rcm")


# --------------------------------------------------------------------------
# Gradients, the GCN, the hetero stack and the serving tier
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_sharded_grads_match_jax_grad(op_pair, mesh_name):
    """``sum(w · D)`` through the port's autograd on a mesh (``dB`` and
    SpMM-SpMM's ``dC`` run sharded on the transpose entries) against
    ``jax.grad`` of the reference's single-device product."""
    ra, ta = pattern_pair("single-hub-row", seed=3)
    rng = np.random.default_rng(7)
    n = ta.n_rows
    c = rng.standard_normal((n, 6) if op_pair == "spmm" else (8, 6))
    b = rng.standard_normal((n, 8))
    w = rng.standard_normal((n, 6))
    spec = ref_api.FusionSpec(**KNOBS)
    jw, jc = jnp.asarray(w, jnp.float32), jnp.asarray(c, jnp.float32)
    if op_pair == "spmm":
        want = [jax.grad(lambda c_: jnp.sum(jw * ref_api.tile_fused_matmul(
            ra, ra, c_, backend="xla", spec=spec)))(jc)]
    else:
        want = jax.grad(lambda b_, c_: jnp.sum(jw * ref_api.tile_fused_matmul(
            ra, b_, c_, backend="xla", spec=spec)), argnums=(0, 1))(
                jnp.asarray(b, jnp.float32), jc)
    tc = torch.tensor(c, dtype=torch.float32, requires_grad=True)
    tb = torch.tensor(b, dtype=torch.float32, requires_grad=True)
    ops = (ta, ta, tc) if op_pair == "spmm" else (ta, tb, tc)
    d = api.tile_fused_matmul(*ops, spec=_spec(mesh_name, "reduce_scatter"))
    (torch.as_tensor(w, dtype=torch.float32) * d).sum().backward()
    got = [tc.grad] if op_pair == "spmm" else [tb.grad, tc.grad]
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=TOL,
                                   atol=TOL)
    stats = api.schedule_cache_stats()
    assert stats["transpose_entries"] >= 1
    assert any(e.transpose and e.shard is not None
               for e in api._schedule_cache.values())


def _gcn_pair(seed=0):
    cfg = RefGCNConfig(n_nodes=96, in_dim=16, hidden_dim=16, out_dim=8,
                       n_layers=2)
    adj = ref_hub_powerlaw(96, 4, seed=seed)
    ref = RefGCN(cfg, adj, **KNOBS)
    params = ref.init_params(jax.random.PRNGKey(seed))
    model = GCN(GCNConfig(**dataclasses.asdict(cfg)), as_port(adj),
                spec=api.FusionSpec(**KNOBS), device="cpu")
    model.params_from_jax([np.asarray(p) for p in params])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((96, 16)).astype(np.float32)
    y = rng.integers(0, 8, 96)
    return ref, params, model, x, y


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_gcn_on_a_mesh_matches_the_reference(mesh_name):
    """``GCN.forward`` / ``loss`` with ``mesh=`` against the reference's
    single-device ``GCN``, and one SGD step of ``make_gcn_train_step``
    with ``mesh=`` against the reference's step."""
    ref, params, model, x, y = _gcn_pair()
    shape, _ = MESHES[mesh_name]
    mesh = cpu_mesh(shape)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = ref.forward(params, jnp.asarray(x), backend="xla")
    with torch.inference_mode():
        got = model(tx, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert model.layer_backends(mesh=mesh) == ["sharded", "sharded"]
    assert all(e.shard is not None for e in model.layer_entries(mesh))
    want_loss = ref.loss(params, jnp.asarray(x), jnp.asarray(y),
                         backend="xla")
    np.testing.assert_allclose(float(model.loss(tx, ty, mesh=mesh)),
                               float(want_loss), rtol=TOL, atol=TOL)
    params, ref_l = ref_train_step(ref, lr=0.1, backend="xla", jit=False)(
        params, jnp.asarray(x), jnp.asarray(y))
    loss = make_gcn_train_step(model, lr=0.1, mesh=mesh)(tx, ty)
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=TOL, atol=TOL)
    for w, p in zip(model.weights, params, strict=True):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p),
                                   rtol=TOL, atol=TOL)
    misses = api.schedule_cache_stats()["misses"]
    make_gcn_train_step(model, lr=0.1, mesh=mesh)(tx, ty)
    assert api.schedule_cache_stats()["misses"] == misses


def test_hetero_stack_on_a_mesh_matches_the_reference():
    """``hetero_fused_matmul`` lets the spec's mesh through: the stacked
    product on a mesh against the reference's single-device output."""
    rng = np.random.default_rng(0)
    rels = []
    for i, (nj, ni) in enumerate([(40, 36), (30, 30), (24, 32)]):
        dense = ((rng.random((nj, ni)) < 0.15)
                 * rng.standard_normal((nj, ni)))
        from repro.core.sparse.formats import CSR as RefCSR
        a = RefCSR.from_dense(dense)
        rels.append((a, rng.standard_normal((ni, 4 + 2 * i))
                     .astype(np.float32),
                     rng.standard_normal((4 + 2 * i, 6)).astype(np.float32)))
    want = ref_hetero.hetero_fused_matmul(
        [(a, jnp.asarray(b), jnp.asarray(c)) for a, b, c in rels],
        backend="xla", spec=ref_api.FusionSpec(**KNOBS))
    spec = _spec("1.5d", "reduce_scatter")
    got = hetero.hetero_fused_matmul(
        [(as_port(a), torch.from_numpy(b), torch.from_numpy(c))
         for a, b, c in rels], spec=spec)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    assert api.schedule_cache_stats()["layout_15d"] == 1


def test_serving_tier_bails_on_a_mesh_entry():
    """``incremental_update`` patches single-device entries only: a mesh
    entry of the same pattern is rebuilt, as in the reference."""
    base = as_port(ref_hub_powerlaw(96, 4, seed=1))
    a_old = induced_subgraph(base, 0, 80)
    dirty = np.array([3, 7])
    a_new = perturb_rows(a_old, dirty, seed=5)
    plain = api.get_schedule(a_old, b_col=8, c_col=8,
                             spec=api.FusionSpec(**KNOBS))
    meshed = api.get_schedule(a_old, b_col=8, c_col=8,
                              spec=api.FusionSpec(**KNOBS,
                                                  mesh=cpu_mesh((4,))))
    assert meshed.shard is not None
    assert serving.incremental_update(a_old, meshed, a_new, dirty,
                                      cache_size=KNOBS["cache_size"]) is None
    fallback = dataclasses.replace(plain, mesh_key=meshed.mesh_key)
    assert serving.incremental_update(a_old, fallback, a_new, dirty,
                                      cache_size=KNOBS["cache_size"]) is None


# --------------------------------------------------------------------------
# The reference's own sharded executor on a forced 8-device host platform
# --------------------------------------------------------------------------
# Only overlap=True runs here: under jax 0.9.0 the reference's overlap=False
# cells raise ("scan body function carry input and carry output must have
# equal types ... varying manual axes do not match"): ``fused_ops._ell_rows``'
# ``lax.scan`` (src/repro/core/tilefusion/fused_ops.py:33) starts its carry
# unvarying inside the ``shard_map`` built with ``check_vma=not async_halo``
# (sharded.py:759-761).  The port's sync arm is held to the overlap arm and
# to fused_ref above instead.
_REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) == 8, jax.devices()
from repro.core.sparse.random import hub_powerlaw
from repro.core.tilefusion import api
a = hub_powerlaw(96, 4, seed=0)
rng = np.random.default_rng(0)
b = rng.standard_normal((96, 8)).astype(np.float32)
cg = rng.standard_normal((8, 8)).astype(np.float32)
cs = rng.standard_normal((96, 8)).astype(np.float32)
out = {}
for name, shape in (("1d", (8,)), ("1.5d", (4, 2)), ("2.5d", (2, 2, 2))):
    mesh = Mesh(np.array(jax.devices()).reshape(shape),
                ("x", "y", "z")[:len(shape)])
    for combine in ("psum", "reduce_scatter"):
        spec = api.FusionSpec(p=2, cache_size=30_000.0, ct_size=32,
                              mesh=mesh, shard_layout=name,
                              shard_combine=combine, overlap=True)
        out[f"gemm/{name}/{combine}"] = np.asarray(api.tile_fused_matmul(
            a, jnp.asarray(b), jnp.asarray(cg), backend="sharded",
            spec=spec))
        out[f"spmm/{name}/{combine}"] = np.asarray(api.tile_fused_matmul(
            a, a, jnp.asarray(cs), backend="sharded", spec=spec))
        e = api.get_schedule(a, b_col=8, c_col=8, spec=spec)
        assert e.shard is not None and e.shard.layout == name, e.shard
np.savez(sys.argv[1], b=b, cg=cg, cs=cs, **out)
print("REF8 OK")
"""


def test_port_matches_the_reference_sharded_executor(tmp_path):
    path = tmp_path / "ref8.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO_ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "REF8 OK" in proc.stdout
    ref = np.load(path)
    ta = as_port(ref_hub_powerlaw(96, 4, seed=0))
    b, cg, cs = (torch.from_numpy(ref[k]) for k in ("b", "cg", "cs"))
    for name in MESHES:
        for combine in COMBINES:
            for overlap in (True, False):
                spec = _spec(name, combine, overlap)
                got = api.tile_fused_matmul(ta, b, cg, backend="sharded",
                                            spec=spec)
                np.testing.assert_allclose(
                    got.numpy(), ref[f"gemm/{name}/{combine}"], rtol=TOL,
                    atol=TOL, err_msg=f"gemm/{name}/{combine}/{overlap}")
                got = api.tile_fused_matmul(ta, ta, cs, backend="sharded",
                                            spec=spec)
                np.testing.assert_allclose(
                    got.numpy(), ref[f"spmm/{name}/{combine}"], rtol=TOL,
                    atol=TOL, err_msg=f"spmm/{name}/{combine}/{overlap}")


# --------------------------------------------------------------------------
# The port stands alone
# --------------------------------------------------------------------------
def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = [os.path.join(root, f)
             for root, _, names in os.walk(os.path.join(REPO_ROOT, "src",
                                                        "repro_torch"))
             for f in names if f.endswith(".py")]
    files.append(os.path.join(REPO_ROOT, "chip_smoke.py"))
    bad = [f for f in files if pattern.search(open(f).read())]
    assert not bad, bad


def test_sharding_module_imports_first():
    """``models.sharding`` and the tile-fusion package import each other's
    modules: importing the mesh module first must work too."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO_ROOT, "src"),
         os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    proc = subprocess.run(
        [sys.executable, "-c", "from repro_torch.models.sharding import "
         "Mesh; print(Mesh(['cpu'] * 2, 'x').shape)"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "(2,)"
