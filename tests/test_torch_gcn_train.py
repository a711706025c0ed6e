"""The port's GCN training against the JAX package's, step for step.

The 3-layer model of ``tests/test_grad.py`` (96 nodes, 16 → 16 → 16 → 8)
on a banded and a power-law graph, with the reference's weights carried
across by ``params_from_jax``: the port's ``make_gcn_train_step`` against
the reference's (eager, ``jit=False``) for 3 SGD steps, losses and
weights within 2e-3 after each step.  Training inspects one transpose
entry per layer shape whose ``dB`` is computed and nothing after step 1.
The ``REDUCED`` 2-layer model trains under every backend, and the CLI
example trains on the CPU.
"""
import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port
from repro.configs.gcn import GCNConfig as RefGCNConfig
from repro.configs.gcn import REDUCED as REF_REDUCED
from repro.core.sparse.random import banded_spd, powerlaw_graph
from repro.launch.steps import make_gcn_train_step as ref_train_step
from repro.models.gcn import GCN as RefGCN
from repro_torch.configs.gcn import GCNConfig, REDUCED
from repro_torch.core.tilefusion import api
from repro_torch.launch.steps import make_gcn_train_step
from repro_torch.models.gcn import GCN

#: port backend -> reference backend
BACKEND_MAP = {"auto": "auto", "cuda": "pallas", "torch": "xla",
               "unfused": "unfused"}
GRAPHS = {"banded": lambda n: banded_spd(n, 4, seed=1),
          "powerlaw": lambda n: powerlaw_graph(n, 5, seed=1)}
THREE_LAYERS = RefGCNConfig(n_nodes=96, in_dim=16, hidden_dim=16, out_dim=8,
                            n_layers=3)
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "torch_gcn_train.py"


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _pair(ref_cfg, adj, *, seed: int, knobs=None):
    """(reference model, its params, port model with the same weights)."""
    knobs = KNOBS if knobs is None else knobs
    ref = RefGCN(ref_cfg, adj, **knobs)
    params = ref.init_params(jax.random.PRNGKey(seed))
    model = GCN(GCNConfig(**dataclasses.asdict(ref_cfg)), as_port(adj),
                spec=api.FusionSpec(**knobs), device="cpu")
    model.params_from_jax([np.asarray(p) for p in params])
    return ref, params, model


def _data(cfg, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cfg.n_nodes, cfg.in_dim)).astype(np.float32)
    y = rng.integers(0, cfg.out_dim, cfg.n_nodes)
    return x, y


def _train_both(ref, params, model, x, y, *, backend, steps, lr=0.1):
    """Run both steps ``steps`` times; assert losses and weights agree
    after each step."""
    ref_step = ref_train_step(ref, lr=lr, backend=BACKEND_MAP[backend],
                              jit=False)
    step = make_gcn_train_step(model, lr=lr, backend=backend)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for i in range(steps):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PALLAS_INTERPRET", "1")
            params, want = ref_step(params, jx, jy)
        got = step(tx, ty)
        assert not got.requires_grad
        np.testing.assert_allclose(float(got), float(want), rtol=2e-3,
                                   atol=2e-3, err_msg=f"loss, step {i + 1}")
        for w, p in zip(model.weights, params, strict=True):
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(p),
                                       rtol=2e-3, atol=2e-3,
                                       err_msg=f"weights, step {i + 1}")
        losses.append(float(got))
    return losses


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_train_steps_match_reference(graph):
    cfg = THREE_LAYERS
    ref, params, model = _pair(cfg, GRAPHS[graph](cfg.n_nodes), seed=0)
    x, y = _data(cfg, 0)
    losses = _train_both(ref, params, model, x, y, backend="auto", steps=3)
    assert losses[-1] < losses[0], "SGD went uphill"


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_one_transpose_inspection_per_shape(graph):
    """Layers 2 and 3 need ``dB`` through a transpose entry, (16, 16) and
    (8, 16): two entries, as in the reference (whose extra first-layer
    ``dB`` shares layer 2's shape).  Steps after the first inspect
    nothing."""
    api.clear_schedule_cache()
    cfg = THREE_LAYERS
    _, _, model = _pair(cfg, GRAPHS[graph](cfg.n_nodes), seed=0)
    x, y = (torch.from_numpy(a) for a in _data(cfg, 0))
    step = make_gcn_train_step(model, lr=0.1)
    step(x, y)
    stats = api.schedule_cache_stats()
    assert stats["transpose_entries"] == 2
    for _ in range(3):
        step(x, y)
    after = api.schedule_cache_stats()
    assert after["misses"] == stats["misses"], "training re-inspected"
    assert after["transpose_entries"] == 2


@pytest.mark.parametrize("backend", sorted(BACKEND_MAP))
def test_reduced_model_trains_under_each_backend(backend):
    """The ``REDUCED`` 2-layer model on the power-law graph at the default
    spec: two steps equal to the reference's under the mapped backend.
    Only layer 2's ``dB`` runs on a transpose entry (the features need no
    gradient); the unfused backend inspects none."""
    api.clear_schedule_cache()
    cfg = REF_REDUCED
    adj = powerlaw_graph(cfg.n_nodes, 8, seed=0)
    ref, params, model = _pair(cfg, adj, seed=2, knobs={})
    assert dataclasses.asdict(REDUCED) == dataclasses.asdict(cfg)
    x, y = _data(cfg, 1)
    _train_both(ref, params, model, x, y, backend=backend, steps=2, lr=0.3)
    expected = 0 if backend == "unfused" else 1
    assert api.schedule_cache_stats()["transpose_entries"] == expected


def test_example_trains_on_the_cpu(capsys):
    losses = runpy.run_path(str(EXAMPLE))["main"](
        ["--device", "cpu", "--nodes", "512", "--steps", "2"])
    out = capsys.readouterr().out
    assert "re-inspections during loop: 0" in out
    assert set(losses) == {"auto", "unfused"}
    assert all(np.isfinite(v) for v in losses.values())
    np.testing.assert_allclose(losses["auto"], losses["unfused"], rtol=2e-3)
