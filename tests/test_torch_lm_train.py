"""LM training in the port against the JAX package: the ``sparse-band``
block (``decay_band_csr``, ``band_mix_apply`` and its gradients, the
model's ``forward``), ``cross_entropy``, AdamW and the train step.

Both packages compute the same model: the reference's ``init_params`` tree
is loaded into the port with ``Transformer.params_from_jax``, and inputs
are made with numpy from a seed.  The config is the reference test's
(``tests/test_sparse_layers.py``): stablelm-1.6b ``REDUCED`` with
``block_pattern="sparse-band"``, ``band_window=8``, ``ssm_head_dim=16``, B
2, S 32.  Tolerances: f32 ``rtol=atol=2e-3`` (the reference's parity bar;
the sides differ in summation order); bf16 3e-2 relative to the largest
value, as ``test_torch_lm.py`` grounds it (bf16 rounds at different
places in the two frameworks; seeds 0-3 gave 1.6e-2 to 2.5e-2 for the
two-block forward and at most 6.8e-3 for the mixer alone).  AdamW fed the same gradients is held to
1e-6: the two sides do the same f32 arithmetic.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jax_steps
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.core.tilefusion import api
from repro_torch.launch import serve, steps
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, adamw

TOL = 2e-3
BF16_TOL = 3e-2
B, SEQ = 2, 32
ARCHS = ["qwen2.5-3b", "stablelm-1.6b", "minitron-8b",
         "granite-moe-3b-a800m", "llama4-scout-17b-a16e", "minicpm3-4b",
         "hymba-1.5b"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _cfg(dtype="float32"):
    base = get_config("stablelm-1.6b", reduced=True)
    return dataclasses.replace(base, block_pattern="sparse-band",
                               band_window=8, band_decay=0.9,
                               ssm_head_dim=16, dtype=dtype)


def _models(cfg, seed=0):
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, SEQ))
            for k in ("tokens", "labels")}


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- the band ----
@pytest.mark.parametrize("seq,window,decay", [
    (16, 4, 0.8), (32, 8, 0.9), (33, 1, 0.5), (5, 10, 0.9), (2048, 32, 0.9)])
def test_decay_band_csr_matches_jax(seq, window, decay):
    want = JS.decay_band_csr(seq, window, decay)
    got = S.decay_band_csr(seq, window, decay)
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for name in ("indptr", "indices", "data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_decay_band_csr_is_memoized_and_checks_decay():
    a = S.decay_band_csr(24, 6, 0.7)
    assert S.decay_band_csr(24, 6, 0.7) is a
    for bad in (0.0, 1.0, 1.5, -0.2):
        with pytest.raises(ValueError, match="decay"):
            S.decay_band_csr(24, 6, bad)


def _mix_inputs(cfg, seed):
    """The reference's mixer weights, ``x (B, S, d)`` and a cotangent."""
    jp = JS.band_mix_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
    wgt = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
    return {k: np.asarray(v) for k, v in jp.items()}, x, wgt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["torch", "cuda", "unfused"])
def test_band_mix_matches_jax(backend, dtype):
    """Port ``"torch"`` / ``"cuda"`` (the kernel arm's glue with the plain
    kernels on the CPU) / ``"unfused"`` against the reference's forced
    fused ``"xla"`` executor."""
    cfg = _cfg(dtype)
    p, x, _ = _mix_inputs(cfg, 1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    a_j = JS.decay_band_csr(SEQ, cfg.band_window, cfg.band_decay)
    want = JS.band_mix_apply({k: jnp.asarray(v, jdt) for k, v in p.items()},
                             cfg, jnp.asarray(x, jdt), a_j, backend="xla")
    a = S.decay_band_csr(SEQ, cfg.band_window, cfg.band_decay)
    got = S.band_mix_apply(
        {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}, cfg,
        torch.from_numpy(x).to(tdt), a, backend=backend)
    assert got.dtype == tdt and got.shape == (B, SEQ, cfg.d_model)
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("backend", ["torch", "cuda", "unfused"])
def test_band_mix_gradients_match_jax(backend):
    """Gradients in ``x``, ``wv``, ``wz`` and ``w_down`` against
    ``jax.grad``.  The band is lower-triangular, so ``Aᵀ ≠ A``: a wrong
    transpose in ``dB = Aᵀ·(Ḋ·Cᵀ)`` or ``Aᵀ·Ḋ`` shows here."""
    cfg = _cfg()
    p, x, wgt = _mix_inputs(cfg, 2)
    a_j = JS.decay_band_csr(SEQ, cfg.band_window, cfg.band_decay)

    def jloss(p, x):
        return (JS.band_mix_apply(p, cfg, x, a_j) * wgt).sum()

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    a = S.decay_band_csr(SEQ, cfg.band_window, cfg.band_decay)
    (S.band_mix_apply(tp, cfg, tx, a, backend=backend)
     * torch.from_numpy(wgt)).sum().backward()
    _close(tx.grad, gx)
    for k in ("wv", "wz", "w_down"):
        _close(tp[k].grad, gp[k])


def test_band_mix_cuda_arm_runs_the_kernel_glue_on_the_cpu():
    """``backend="cuda"`` on CPU tensors takes the kernel arm, whose
    wrappers run their plain versions; the schedule comes from the cache
    on the second call (one inspection a shape)."""
    from repro_torch.kernels import ops
    cfg = _cfg()
    p, x, _ = _mix_inputs(cfg, 3)
    a = S.decay_band_csr(SEQ, cfg.band_window, cfg.band_decay)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    S.band_mix_apply(tp, cfg, torch.from_numpy(x), a)
    misses = api.schedule_cache_stats()["misses"]
    ops.reset_launch_counts()
    S.band_mix_apply(tp, cfg, torch.from_numpy(x), a)
    assert api.schedule_cache_stats()["misses"] == misses
    assert sum(ops.launch_counts().values()) == 0     # plain on the CPU
    entry = api.get_schedule(a, b_col=cfg.d_model, c_col=16 * cfg.n_heads,
                             spec=dataclasses.replace(S._BAND_SPEC,
                                                      dtype_bytes=4))
    assert api.select_backend(entry, "cpu") == "unfused"   # Eq 3's pick


# ------------------------------------------------------------ the model ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_band_forward_matches_jax(dtype):
    cfg = _cfg(dtype)
    params, model = _models(cfg)
    toks = _batch(cfg)["tokens"]
    want = np.asarray(JT.forward(cfg, params, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = model(torch.from_numpy(toks))
    assert got.shape == (B, SEQ, cfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got, want) <= BF16_TOL


def test_impl_torch_routes_the_band_to_the_plain_executor():
    cfg = _cfg()
    _, model = _models(cfg, seed=1)
    toks = torch.from_numpy(_batch(cfg, 1)["tokens"])
    with torch.no_grad():
        torch.testing.assert_close(model(toks, impl="torch"), model(toks),
                                   rtol=1e-5, atol=1e-5)


def test_sparse_band_has_no_decode_path():
    cfg = _cfg()
    model = T.Transformer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sparse-band"):
        model.init_cache(B, SEQ)
    with pytest.raises(NotImplementedError, match="sparse-band"):
        model.decode_step(torch.zeros((B, 1), dtype=torch.int64), None, 0)


def test_params_from_jax_checks_the_sparse_band_tree():
    cfg = _cfg()
    params = jax.tree.map(np.asarray, JT.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    dense = jax.tree.map(np.asarray, JT.init_params(
        dataclasses.replace(cfg, block_pattern="attn"),
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="layer keys"):
        T.Transformer(cfg, device="cpu").params_from_jax(dense)
    with pytest.raises(ValueError, match="layer keys"):
        T.Transformer(dataclasses.replace(cfg, block_pattern="attn"),
                      device="cpu").params_from_jax(params)
    params["layers"]["mix"]["wv"] = params["layers"]["mix"]["wv"][..., :8]
    with pytest.raises(ValueError, match="shape"):
        T.Transformer(cfg, device="cpu").params_from_jax(params)
    del params["layers"]["mix"]["wv"]
    with pytest.raises(ValueError, match="keys"):
        T.Transformer(cfg, device="cpu").params_from_jax(params)


def test_param_count_matches_the_sparse_band_model():
    cfg = _cfg()
    model = T.Transformer(cfg, device="cpu")
    n = sum(p.numel() for name, p in model.named_parameters()
            if "ln" not in name)
    assert n == cfg.param_count()


# ------------------------------------------------------- loss and AdamW ----
def test_cross_entropy_matches_jax():
    """f32 and bf16 logits (the reference is given the same bf16-rounded
    values); the loss is f32 either way."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7))
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(logits).to(dt)
        got = steps.cross_entropy(x, torch.from_numpy(labels))
        want = jax_steps.cross_entropy(jnp.asarray(x.float().numpy()),
                                       jnp.asarray(labels))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_schedule_matches_jax():
    for cfg in (OptConfig(), OptConfig(lr=1e-2, warmup_steps=1,
                                       total_steps=20),
                OptConfig(warmup_steps=0, total_steps=5)):
        jcfg = JOptConfig(**dataclasses.asdict(cfg))
        for step in list(range(0, 25)) + [99, 100, 101, 5000, 10_000,
                                          20_000]:
            want = float(jax_adamw.schedule(jcfg, jnp.float32(step)))
            assert adamw.schedule(cfg, step) == pytest.approx(
                want, rel=1e-6, abs=1e-12), (cfg, step)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in [(3,), (4, 5), (2, 3, 4)]]
    want = float(jax_adamw.global_norm([jnp.asarray(x) for x in xs]))
    got = adamw.global_norm([torch.from_numpy(x).to(torch.bfloat16)
                             if i == 0 else torch.from_numpy(x)
                             for i, x in enumerate(xs)])
    wantb = float(jax_adamw.global_norm(
        [jnp.asarray(xs[0], jnp.bfloat16)] + [jnp.asarray(x)
                                              for x in xs[1:]]))
    assert float(got) == pytest.approx(wantb, rel=1e-6)
    assert float(adamw.global_norm([torch.from_numpy(x) for x in xs])) \
        == pytest.approx(want, rel=1e-6)


def _stacked_grads(params, seed, scale):
    """Gradients of the shapes of the reference's tree, from numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(np.shape(p)) * scale).astype(
            np.float32), params)


def _port_order(model, tree):
    """The reference tree's leaves in the order of
    ``model.named_parameters()`` (layer ``i`` of a stacked leaf for block
    ``i``)."""
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            node = tree["layers"]
            for k in parts[2:]:
                node = node[k]
            out.append(np.asarray(node)[int(parts[1])])
        else:
            node = tree
            for k in parts:
                node = node[k]
            out.append(np.asarray(node))
    return out


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_adamw_update_matches_jax_with_stacked_decay(scale):
    """One update on the sparse-band model's loaded tree, fed the same
    gradients: ``scale=10`` clips (norm ≫ 1), ``1e-3`` does not.  The
    reference decays its stacked ``(L, d)`` layer norms and not ``ln_f``;
    ``Transformer.decay_mask`` reproduces that, and the unstacked rank rule
    would not.
    """
    cfg = _cfg()
    params, model = _models(cfg, seed=2)
    grads = _stacked_grads(params, 6, scale)
    ocfg = OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    jstate = jax_adamw.init(params)
    new, jstate, jm = jax_adamw.update(
        JOptConfig(**dataclasses.asdict(ocfg)),
        jax.tree.map(jnp.asarray, grads), jstate, params)
    named = list(model.named_parameters())
    mask = model.decay_mask()
    assert dict(zip([n for n, _ in named], mask)) == {
        n: n != "ln_f" for n, _ in named}
    ps = [p for _, p in named]
    state = adamw.init(ps)
    gs = [torch.from_numpy(g) for g in _port_order(model, grads)]
    state, m = adamw.update(ocfg, gs, state, ps, mask)
    assert state.step == 1 and m["lr"] == pytest.approx(float(jm["lr"]))
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    for (name, p), want, mu, wmu in zip(
            named, _port_order(model, new), state.mu,
            _port_order(model, jstate.mu)):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(mu.numpy(), wmu, rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    # the rank rule on the unstacked layer norms leaves them undecayed
    _, model2 = _models(cfg, seed=2)
    ps2 = list(model2.parameters())
    adamw.update(ocfg, gs, adamw.init(ps2), ps2,
                 [p.dim() >= 2 for p in ps2])
    ln1 = [n for n, _ in named].index("blocks.0.ln1")
    assert not np.allclose(ps2[ln1].detach().numpy(),
                           _port_order(model, new)[ln1], atol=1e-3)


def test_adamw_update_keeps_bf16_parameters_bf16():
    p = torch.ones(4, 3, dtype=torch.bfloat16)
    state = adamw.init([p])
    assert state.mu[0].dtype == torch.float32
    adamw.update(OptConfig(lr=0.1, warmup_steps=1), [torch.ones_like(p)],
                 state, [p], [True])
    assert p.dtype == torch.bfloat16 and bool((p < 1).all())


def test_adamw_converges_quadratic():
    """Twin of ``test_substrate.py::test_adamw_converges_quadratic``."""
    w = torch.tensor([3.0, -2.0], requires_grad=True)
    opt_cfg = OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                        weight_decay=0.0)
    state = adamw.init([w])
    for _ in range(150):
        w.grad = None
        (w ** 2).sum().backward()
        state, _ = adamw.update(opt_cfg, [w.grad], state, [w], [False])
    assert float(w.detach().abs().max()) < 1e-2


def test_grad_clipping():
    """Twin of ``test_substrate.py::test_grad_clipping``."""
    w = torch.ones(4)
    state = adamw.init([w])
    _, m = adamw.update(OptConfig(clip_norm=1.0), [torch.full((4,), 1e9)],
                        state, [w], [False])
    assert float(m["grad_norm"]) > 1e8   # reported pre-clip


# ----------------------------------------------------------- train step ----
def _jax_losses_and_grads(cfg, params, batch, ocfg, n_steps):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jax_steps.make_loss_fn(cfg, rules=None)
    grads = jax.grad(lambda p: loss_fn(p, jb)[0])(params)
    step = jax_steps.make_train_step(
        cfg, JOptConfig(**dataclasses.asdict(ocfg)), rules=None, jit=True)
    state, losses = jax_adamw.init(params), []
    for _ in range(n_steps):
        params, state, m = step(params, state, jb)
        losses.append(float(m["loss"]))
    return losses, grads


#: the losses of later steps: Adam moves a weight with a tiny gradient by
#: about ±lr whatever the gradient's size, so rounding-level differences
#: between the frameworks could grow step by step.  Seeds 0-3 gave at most
#: 1.6e-7 relative at step 1 and 5.0e-6 over steps 2-6.
LATER_STEP_TOL = 1e-4


def test_train_step_matches_jax():
    """6 AdamW steps of the sparse-band model against the reference's
    jitted ``make_train_step`` (f32): the step-1 gradients tensor for
    tensor (2e-3), the losses step for step."""
    cfg = _cfg()
    params, model = _models(cfg)
    batch = _batch(cfg)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    want_losses, want_grads = _jax_losses_and_grads(cfg, params, batch,
                                                    ocfg, 6)
    step = steps.make_train_step(model, ocfg)
    state = adamw.init(model.parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for i in range(6):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        if i == 0:
            for (name, p), w in zip(model.named_parameters(),
                                    _port_order(model, want_grads)):
                np.testing.assert_allclose(p.grad.numpy(), w, rtol=TOL,
                                           atol=TOL, err_msg=name)
    assert losses[0] == pytest.approx(want_losses[0], rel=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=LATER_STEP_TOL)
    assert min(losses[2:]) < losses[0], losses


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    """Twin of ``test_models.py::test_train_step_decreases_loss`` for the
    port's dense, MoE, MLA and hybrid archs, on the CPU (the training
    forward's attention, ``layers.scan_attention``, the reference's
    chunked XLA attention)."""
    cfg = get_config(arch, reduced=True)
    model = T.Transformer(cfg, device="cpu")
    step = steps.make_train_step(
        model, OptConfig(lr=1e-2, warmup_steps=1, total_steps=20))
    state = adamw.init(model.parameters())
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16)))
             for k in ("tokens", "labels")}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert not np.isnan(losses).any()
    assert min(losses[2:]) < losses[0], losses


# ------------------------------------------------ serving records no graph --
def test_serving_steps_record_no_graph():
    cfg = get_config("qwen2.5-3b", reduced=True)
    model = T.Transformer(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 6)))
    logits = steps.make_prefill_step(model)(toks)
    assert logits.grad_fn is None and not logits.requires_grad
    tok, cache = steps.make_serve_step(model)(toks, model.init_cache(2, 8),
                                               0)
    assert tok.grad_fn is None
    assert all(c.grad_fn is None for c in cache)
    tokens, _ = serve.generate(model, toks, 3)
    assert tokens.grad_fn is None and tokens.shape == (2, 3)
    # forward itself follows the caller's grad mode
    assert model(toks).grad_fn is not None
    with torch.inference_mode():
        assert model(toks).grad_fn is None


# ------------------------------------- LM kernels have no backward ----
def _lm_kernel_call(name, requires_grad):
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(8)

    def t(*shape):
        return torch.randn(shape, generator=gen).requires_grad_(
            requires_grad)
    if name == "flash_attention":
        return lambda: ops.flash_attention(t(1, 2, 8, 16), t(1, 2, 8, 16),
                                           t(1, 2, 8, 16))
    if name == "fused_ffn":
        return lambda: ops.fused_ffn(t(8, 16), t(16, 32), t(32, 16))
    return lambda: ops.fused_moe_ffn(t(2, 8, 16), t(2, 16, 32),
                                     t(2, 32, 16))


@pytest.mark.parametrize("name", ["flash_attention", "fused_ffn",
                                  "fused_moe_ffn"])
def test_lm_kernel_wrappers_refuse_grad(name, monkeypatch):
    """With the device check stubbed to take the kernel arm, each LM
    wrapper raises under grad mode for an input that requires grad (its
    output would leave the graph), and otherwise goes on to the launch,
    which raises here for a CPU tensor."""
    from repro_torch.kernels import config
    monkeypatch.setattr(config, "plain_arm", lambda x, impl: False)
    with pytest.raises(NotImplementedError, match="no backward"):
        _lm_kernel_call(name, True)()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _lm_kernel_call(name, False)()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        _lm_kernel_call(name, True)()
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="CUDA tensors"):
        _lm_kernel_call(name, True)()
