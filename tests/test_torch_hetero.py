"""The port's hetero stack and ``HeteroGCNLayer`` against the JAX
package's, on the CPU.

A twin of ``tests/test_hetero.py``: the stacked CSRs (adjacency on the
square pitch, op 1 on the row pitch) equal to the reference's array for
array; ``hetero_fused_matmul`` against the per-relation loop and the
reference's stacked output on mixed rectangular relations, both op pairs,
each port backend (rtol=atol=2e-3); one inspection per relation set;
composition with ``spec.reorder``; input validation; and
``HeteroGCNLayer`` forward and weight gradients against the reference's
layer and its ``jax.grad``, with the weights carried across by
``params_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port
from test_torch_grad import BACKEND_MAP
from repro.core.sparse.formats import CSR as RefCSR
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import hetero as ref_hetero
from repro.models.hetero_gcn import HeteroGCNLayer as RefLayer
from repro.models.hetero_gcn import HeteroGraph as RefGraph
from repro_torch.core.tilefusion import api, hetero
from repro_torch.models.hetero_gcn import HeteroGCNLayer, HeteroGraph

BACKENDS = ("auto", "torch", "cuda", "unfused")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _rect_csr(n_rows, n_cols, seed, density=0.15) -> RefCSR:
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_rows, n_cols)) < density)
             * rng.standard_normal((n_rows, n_cols)))
    return RefCSR.from_dense(dense)


def _mixed_relations(c_col=6, sparse_op1=False, seed=0):
    """The reference test's four relations of distinct rectangular shapes,
    as numpy: ``[(a, b_or_a1, c)]`` with reference CSRs."""
    rng = np.random.default_rng(seed)
    shapes = [(40, 36), (30, 30), (24, 32), (18, 18)]
    rels = []
    for i, (nj, ni) in enumerate(shapes):
        a = _rect_csr(nj, ni, seed=seed + i)
        if sparse_op1:
            nk = 20 + 4 * i
            a1 = _rect_csr(ni, nk, seed=seed + 10 + i, density=0.2)
            rels.append((a, a1, rng.standard_normal((nk, c_col))
                         .astype(np.float32)))
        else:
            b_col = 4 + 2 * i
            rels.append((a, rng.standard_normal((ni, b_col))
                         .astype(np.float32),
                         rng.standard_normal((b_col, c_col))
                         .astype(np.float32)))
    return rels


def _as_port(rels):
    def conv(x):
        return as_port(x) if isinstance(x, RefCSR) else torch.from_numpy(x)
    return [tuple(conv(x) for x in r) for r in rels]


def _as_ref(rels):
    def conv(x):
        return x if isinstance(x, RefCSR) else jnp.asarray(x)
    return [tuple(conv(x) for x in r) for r in rels]


def _loop_oracle(rels):
    outs = []
    for a, op1, c in rels:
        mid = op1.to_dense() if isinstance(op1, RefCSR) else op1
        outs.append(a.to_dense() @ (np.asarray(mid, np.float64)
                                    @ np.asarray(c, np.float64)))
    return outs


@pytest.mark.parametrize("sparse_op1", [False, True])
def test_stacked_csrs_equal_the_reference(sparse_op1):
    rels = _mixed_relations(sparse_op1=sparse_op1)
    got = hetero.stack_adjacencies([as_port(r[0]) for r in rels])
    want = ref_hetero.stack_adjacencies([r[0] for r in rels])
    for field in ("offsets", "pitches", "row_sizes", "col_sizes"):
        assert getattr(got, field) == getattr(want, field)
    assert got.n_relations == want.n_relations == 4
    pairs = [(got.a, want.a)]
    if sparse_op1:
        pairs.append((hetero._stack_op1(got, [as_port(r[1]) for r in rels]),
                      ref_hetero._stack_op1(want, [r[1] for r in rels])))
    for g, w in pairs:
        assert (g.n_rows, g.n_cols) == (w.n_rows, w.n_cols)
        for field in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))


@pytest.mark.parametrize("sparse_op1", [False, True],
                         ids=["gemm_spmm", "spmm_spmm"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_hetero_fused_matches_loop_and_reference(backend, sparse_op1):
    rels = _mixed_relations(sparse_op1=sparse_op1)
    spec = api.FusionSpec(**KNOBS)
    got = hetero.hetero_fused_matmul(_as_port(rels), backend=backend,
                                     spec=spec)
    loop = hetero.hetero_loop_matmul(_as_port(rels), backend=backend,
                                     spec=spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        want = ref_hetero.hetero_fused_matmul(
            _as_ref(rels), backend=BACKEND_MAP[backend],
            spec=ref_api.FusionSpec(**KNOBS))
    oracle = _loop_oracle(rels)
    assert len(got) == len(rels)
    for g, lp, w, o, (a, _, _) in zip(got, loop, want, oracle, rels):
        assert tuple(g.shape) == (a.n_rows, o.shape[1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(g.numpy(), o, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(lp.numpy(), o, rtol=2e-3, atol=2e-3)


def test_hetero_single_inspection_per_relation_set():
    """N relations cost ONE schedule entry, and repeat calls with fresh
    dense operands re-stack and re-inspect nothing."""
    api.clear_schedule_cache()
    hetero.clear_stack_cache()
    spec = api.FusionSpec(**KNOBS)
    rels = _as_port(_mixed_relations())
    hetero.hetero_fused_matmul(rels, backend="torch", spec=spec)
    stats = api.schedule_cache_stats()
    assert stats["misses"] == 1
    stack = hetero.stack_adjacencies([r[0] for r in rels])
    g = torch.Generator().manual_seed(99)
    rels2 = [(a, b, torch.randn(c.shape, generator=g)) for a, b, c in rels]
    hetero.hetero_fused_matmul(rels2, backend="torch", spec=spec)
    after = api.schedule_cache_stats()
    assert after["misses"] == 1 and after["hits"] >= stats["hits"] + 1
    assert hetero.stack_adjacencies([r[0] for r in rels]) is stack


@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
@pytest.mark.parametrize("sparse_op1", [False, True])
def test_hetero_grad_matches_reference(sparse_op1, backend):
    """Gradients of ``Σ_r Σ D_r²`` through the stack (the dense
    block-diagonal assembly and the row concatenation included) against
    ``jax.grad`` of the reference's stacked dispatch."""
    rels = _mixed_relations(sparse_op1=sparse_op1)
    spec = api.FusionSpec(**KNOBS)
    leaves = [torch.from_numpy(r[2]).requires_grad_() for r in rels]
    mids = [as_port(r[1]) if sparse_op1
            else torch.from_numpy(r[1]).requires_grad_() for r in rels]
    outs = hetero.hetero_fused_matmul(
        [(as_port(r[0]), m, c) for r, m, c in zip(rels, mids, leaves)],
        backend=backend, spec=spec)
    sum((d ** 2).sum() for d in outs).backward()
    got = [c.grad for c in leaves] + ([] if sparse_op1
                                      else [m.grad for m in mids])

    def loss(cs, bs):
        mid = [r[1] for r in rels] if sparse_op1 else bs
        outs = ref_hetero.hetero_fused_matmul(
            list(zip([r[0] for r in rels], mid, cs)),
            backend=BACKEND_MAP[backend], spec=ref_api.FusionSpec(**KNOBS))
        return sum(jnp.sum(d ** 2) for d in outs)
    cs = [jnp.asarray(r[2]) for r in rels]
    bs = None if sparse_op1 else [jnp.asarray(r[1]) for r in rels]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        g_cs, g_bs = jax.grad(loss, argnums=(0, 1))(cs, bs)
    want = list(g_cs) + ([] if sparse_op1 else list(g_bs))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("ordering", ["rcm", "auto"])
@pytest.mark.parametrize("sparse_op1", [False, True])
def test_hetero_composes_with_reorder(sparse_op1, ordering):
    """``spec.reorder`` applies to the stacked square pattern like any
    other: the reference's ordering, and the loop oracle's outputs."""
    rels = _mixed_relations(sparse_op1=sparse_op1, seed=3)
    spec_kw = dict(KNOBS, reorder=ordering)
    got = hetero.hetero_fused_matmul(_as_port(rels), backend="torch",
                                     spec=api.FusionSpec(**spec_kw))
    for g, o in zip(got, _loop_oracle(rels)):
        np.testing.assert_allclose(g.numpy(), o, rtol=2e-3, atol=2e-3)
    stack = hetero.stack_adjacencies([as_port(r[0]) for r in rels])
    ref_stack = ref_hetero.stack_adjacencies([r[0] for r in rels])
    b_col = 6 if sparse_op1 else sum(r[1].shape[1] for r in rels)
    kw = dict(b_col=b_col, c_col=6, b_is_sparse=sparse_op1)
    entry = api.get_schedule(stack.a, spec=api.FusionSpec(**spec_kw,
                                                          dtype_bytes=4),
                             **kw)
    want = ref_api.get_schedule(ref_stack.a,
                                spec=ref_api.FusionSpec(**spec_kw), **kw)
    assert entry.reorder == want.reorder
    if ordering == "rcm":
        np.testing.assert_array_equal(entry.reorder_perm, want.reorder_perm)


def test_hetero_input_validation():
    rels = _as_port(_mixed_relations())
    with pytest.raises(ValueError, match="at least one"):
        hetero.hetero_fused_matmul([])
    with pytest.raises(ValueError, match="at least one"):
        hetero.stack_adjacencies([])
    with pytest.raises(ValueError, match="triple"):
        hetero.hetero_fused_matmul([rels[0][:2]])
    sparse = _as_port(_mixed_relations(sparse_op1=True))
    with pytest.raises(ValueError, match="mix dense and sparse"):
        hetero.hetero_fused_matmul([rels[0], sparse[1]])
    a, b, c = rels[0]
    with pytest.raises(ValueError, match="c_col"):
        hetero.hetero_fused_matmul([rels[0], (rels[1][0], rels[1][1],
                                              rels[1][2][:, :3])])
    with pytest.raises(ValueError, match="rows"):
        hetero.hetero_fused_matmul([(a, b[:-1], c)])
    with pytest.raises(ValueError, match="c has"):
        hetero.hetero_fused_matmul([(a, b, c[:-1])])
    sa, sa1, sc = sparse[0]
    with pytest.raises(ValueError, match="op-1 has"):
        hetero.hetero_fused_matmul([(sa, sparse[1][1], sc)])
    with pytest.raises(ValueError, match="c has"):
        hetero.hetero_fused_matmul([(sa, sa1, sc[:-1])])


def _typed_graph():
    counts = {"user": 30, "item": 24, "tag": 12}
    relations = {
        ("user", "buys", "item"): _rect_csr(24, 30, seed=1),
        ("item", "bought_by", "user"): _rect_csr(30, 24, seed=2),
        ("tag", "tags", "item"): _rect_csr(24, 12, seed=3),
        ("user", "follows", "user"): _rect_csr(30, 30, seed=4),
    }
    return counts, relations


def test_hetero_graph_validates_shapes():
    counts, relations = _typed_graph()
    port = {k: as_port(v) for k, v in relations.items()}
    assert HeteroGraph(counts, port).rel_keys == sorted(relations)
    bad = dict(port)
    bad[("tag", "tags", "item")] = as_port(_rect_csr(23, 12, seed=3))
    with pytest.raises(ValueError, match="rows"):
        HeteroGraph(counts, bad)
    bad[("tag", "tags", "item")] = as_port(_rect_csr(24, 11, seed=3))
    with pytest.raises(ValueError, match="cols"):
        HeteroGraph(counts, bad)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hetero_gcn_layer_matches_reference(backend):
    counts, relations = _typed_graph()
    in_dims = {"user": 8, "item": 6, "tag": 4}
    ref_layer = RefLayer(RefGraph(counts, relations), in_dims, out_dim=5,
                         spec=ref_api.FusionSpec(**KNOBS), backend="xla")
    params = ref_layer.init_params(np.random.default_rng(0))
    layer = HeteroGCNLayer(
        HeteroGraph(counts, {k: as_port(v) for k, v in relations.items()}),
        in_dims, out_dim=5, spec=api.FusionSpec(**KNOBS), backend=backend,
        device="cpu")
    layer.params_from_jax({k: np.asarray(v) for k, v in params.items()})
    assert layer.entry.traffic_model == pytest.approx(
        ref_layer.entry.traffic_model)
    rng = np.random.default_rng(1)
    feats = {t: rng.standard_normal((n, in_dims[t])).astype(np.float32)
             for t, n in counts.items()}
    jfeats = {t: jnp.asarray(v) for t, v in feats.items()}
    tfeats = {t: torch.from_numpy(v) for t, v in feats.items()}
    want = ref_layer(params, jfeats)
    got = layer(tfeats)
    plain = layer.reference(tfeats)
    assert sorted(got) == sorted(want) == sorted(plain)
    for t in want:
        np.testing.assert_allclose(got[t].detach().numpy(),
                                   np.asarray(want[t]), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(plain[t].detach().numpy(),
                                   np.asarray(want[t]), rtol=2e-3, atol=2e-3)
    sum((v ** 2).sum() for v in got.values()).backward()
    g_ref = jax.grad(lambda p: sum(jnp.sum(v ** 2) for v in ref_layer(
        p, jfeats).values()))(params)
    for key, w in layer.params().items():
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_ref[key]),
                                   rtol=2e-3, atol=2e-3, err_msg=str(key))


def test_hetero_gcn_layer_weights_and_device():
    counts, relations = _typed_graph()
    graph = HeteroGraph(counts, {k: as_port(v) for k, v in
                                 relations.items()})
    in_dims = {"user": 8, "item": 6, "tag": 4}
    one = HeteroGCNLayer(graph, in_dims, 5, device="cpu", seed=3)
    two = HeteroGCNLayer(graph, in_dims, 5, device="cpu", seed=3)
    assert len(list(one.parameters())) == len(relations)
    for (key, w), v in zip(one.params().items(), two.weights):
        assert tuple(w.shape) == (in_dims[key[0]], 5)
        assert torch.equal(w, v)
    with pytest.raises(ValueError, match="relations"):
        one.params_from_jax({})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HeteroGCNLayer(graph, in_dims, 5)


def test_hetero_gcn_layer_with_autotune_and_reorder():
    """The layer takes the new knobs: its stacked entry is the sweep's
    winner (or carries the ordering), and its outputs match the loop."""
    counts, relations = _typed_graph()
    graph = HeteroGraph(counts, {k: as_port(v) for k, v in
                                 relations.items()})
    in_dims = {"user": 8, "item": 6, "tag": 4}
    rng = np.random.default_rng(2)
    feats = {t: torch.from_numpy(rng.standard_normal(
        (n, in_dims[t])).astype(np.float32)) for t, n in counts.items()}
    for spec in (api.FusionSpec(**KNOBS, autotune=True),
                 api.FusionSpec(**KNOBS, reorder="rcm")):
        layer = HeteroGCNLayer(graph, in_dims, 5, spec=spec, device="cpu")
        assert (layer.entry.autotuned is not None if spec.autotune
                else layer.entry.reorder == "rcm")
        with torch.inference_mode():
            got, want = layer(feats, backend="torch"), layer.reference(feats)
        for t in want:
            torch.testing.assert_close(got[t], want[t], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hetero_gcn_layer_first_forward_inspects_nothing(dtype):
    """The schedule warmed in ``__init__`` is the one the first forward
    dispatches to, at the parameters' itemsize."""
    counts, relations = _typed_graph()
    graph = HeteroGraph(counts, {k: as_port(v) for k, v in
                                 relations.items()})
    in_dims = {"user": 8, "item": 6, "tag": 4}
    api.clear_schedule_cache()
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        layer = HeteroGCNLayer(graph, in_dims, 5, device="cpu")
    finally:
        torch.set_default_dtype(default)
    assert layer.entry.dtype_bytes == torch.tensor([], dtype=dtype
                                                   ).element_size()
    misses = api.schedule_cache_stats()["misses"]
    rng = np.random.default_rng(3)
    feats = {t: torch.from_numpy(rng.standard_normal((n, in_dims[t])))
             .to(dtype) for t, n in counts.items()}
    with torch.inference_mode():
        layer(feats, backend="torch")
    assert api.schedule_cache_stats()["misses"] == misses
