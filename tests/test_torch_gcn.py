"""The port's GCN against the JAX package's, with the same weights.

Weights come from ``repro.models.gcn.GCN.init_params`` and are carried
across with ``params_from_jax``; features are numpy arrays from a seed.
The logits must equal the reference forward's at ``rtol=atol=2e-3`` (f32)
under every backend pair, and serving must inspect each layer shape once:
schedule-cache misses stay flat across repeated requests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gcn import REDUCED as REF_REDUCED
from repro.core.sparse.random import banded_spd, powerlaw_graph
from repro.models.gcn import GCN as RefGCN
from repro_torch.configs.gcn import CONFIG, REDUCED
from repro_torch.core.tilefusion import api
from repro_torch.models.gcn import GCN, normalize_adjacency
from test_torch_cells import as_port

BACKEND_MAP = {"auto": "auto", "torch": "xla", "cuda": "pallas",
               "unfused": "unfused"}
GRAPHS = {"powerlaw": lambda n: powerlaw_graph(n, 8, seed=0),
          "banded": lambda n: banded_spd(n, 8, seed=0)}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def test_configs_equal():
    assert dataclasses.asdict(REDUCED) == dataclasses.asdict(REF_REDUCED)
    assert (CONFIG.in_dim, CONFIG.hidden_dim, CONFIG.out_dim,
            CONFIG.n_layers) == (128, 128, 32, 2)


def test_normalize_adjacency_equal():
    from repro.models.gcn import normalize_adjacency as ref_norm
    a = powerlaw_graph(128, 6, seed=2)
    got, want = normalize_adjacency(as_port(a)), ref_norm(a)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype == np.float64


@pytest.mark.parametrize("backend", sorted(BACKEND_MAP))
@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_logits_match_reference(graph, n_layers, backend):
    cfg = dataclasses.replace(REDUCED, n_layers=n_layers)
    adj = GRAPHS[graph](cfg.n_nodes)
    ref = RefGCN(cfg, adj)
    params = ref.init_params(jax.random.PRNGKey(n_layers))
    x = np.random.default_rng(5).standard_normal(
        (cfg.n_nodes, cfg.in_dim)).astype(np.float32)
    rbe = BACKEND_MAP[backend]
    with pytest.MonkeyPatch.context() as mp:
        if rbe == "pallas":
            mp.setenv("PALLAS_INTERPRET", "1")
        want = np.asarray(ref.forward(params, jnp.asarray(x), backend=rbe))
    model = GCN(cfg, as_port(adj), device="cpu")
    model.params_from_jax([np.asarray(p) for p in params])
    got = model(torch.from_numpy(x), backend=backend)
    assert got.shape == (cfg.n_nodes, cfg.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    ref_picks = [ref_api_pick(e) for e in ref.entries]
    assert model.layer_backends() == ref_picks


def ref_api_pick(entry) -> str:
    from repro.core.tilefusion import api as ref_api
    return {"xla": "torch", "pallas": "cuda",
            "unfused": "unfused"}[ref_api.select_backend(entry)]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_serving_inspects_each_layer_shape_once(graph):
    api.clear_schedule_cache()
    cfg = dataclasses.replace(REDUCED, n_layers=3)
    model = GCN(cfg, as_port(GRAPHS[graph](cfg.n_nodes)), device="cpu")
    # layers 1 and 2 share the shape 16 -> 16 and layer 3 is 16 -> 8: two
    # distinct shapes, two inspections
    misses = api.schedule_cache_stats()["misses"]
    assert misses == len({(e.b_col, e.c_col) for e in model.entries})
    rng = np.random.default_rng(0)
    outs = []
    for _ in range(4):
        x = torch.from_numpy(rng.standard_normal(
            (cfg.n_nodes, cfg.in_dim)).astype(np.float32))
        outs.append(model(x))
        assert api.schedule_cache_stats()["misses"] == misses
    assert api.schedule_cache_stats()["hits"] >= 4 * cfg.n_layers
    assert all(torch.isfinite(o).all() for o in outs)


def test_gcn_defaults_to_the_card():
    """Without a card, building a GCN with the default device raises; it
    never runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    adj = as_port(powerlaw_graph(REDUCED.n_nodes, 8, seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GCN(REDUCED, adj)


def test_forward_runs_under_inference_mode():
    adj = as_port(powerlaw_graph(REDUCED.n_nodes, 8, seed=0))
    model = GCN(REDUCED, adj, device="cpu", seed=3)
    assert all(w.requires_grad for w in model.weights)
    out = model(torch.randn(REDUCED.n_nodes, REDUCED.in_dim))
    assert out.is_inference()
    same = GCN(REDUCED, adj, device="cpu", seed=3)
    for w, v in zip(model.weights, same.weights):
        assert torch.equal(w, v)
