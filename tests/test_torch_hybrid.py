"""The port's chunked linear recurrence, its mamba heads and the
``attn+mamba`` hybrid decoder (``hymba-1.5b``) against the JAX package:
``chunked_linear_recurrence`` against the reference's and a float64
stepwise oracle (with and without a carried-in state, the final state
included) and its gradients against ``jax.grad`` (strong decay too),
``linear_recurrence_step``, ``mamba_apply`` in every path, and the model at
its ``REDUCED`` size: forward, prefill plus decode with the caches (the
ring buffer wraps), decode against forward, the ring buffer against the
full window, 6 train steps, the decay set, checkpoints both ways, the
parameter count and the CLIs.

Inputs are made with numpy from a seed, and the reference's weights are
loaded with ``Transformer.params_from_jax``.  Tolerances: f32
``rtol=atol=2e-3``, the reference's parity bar (``tests/test_ssm.py``
holds its recurrence to its oracle at the same bar); bf16 3e-2 relative
to the largest value, as ``test_torch_lm.py`` grounds it; the train
steps' losses 1e-5 relative (each step starts from the reference's
state).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, adamw

TOL = 2e-3
BF16_TOL = 3e-2
ARCH = "hymba-1.5b"


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype)


def _models(cfg, seed=0):
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


# ------------------------------------------------------ the recurrence ----
def _oracle(q, k, v, log_a, h0=None, normalize=True):
    """The recurrence one step at a time in float64 (the twin of
    ``tests/test_ssm.py``'s oracle, from a carried-in state)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if normalize:
        v = np.concatenate([v, np.ones((b, s, h, 1))], -1)
    hstate = np.zeros((b, h, dk, v.shape[-1])) if h0 is None \
        else np.array(h0, np.float64)
    outs = np.zeros((b, s, h, v.shape[-1]))
    for t in range(s):
        a = np.exp(log_a[:, t])[..., None, None]
        hstate = hstate * a + np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs[:, t] = np.einsum("bhk,bhkv->bhv", q[:, t], hstate)
    if normalize:
        outs = outs[..., :dv] / np.maximum(np.abs(outs[..., dv]),
                                           1.0)[..., None]
    return outs, hstate


def _recurrence_inputs(seed, s, b=2, h=3, dk=4, dv=5, with_h0=False,
                       normalize=True, decay=1.0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = (-decay * np.abs(rng.standard_normal((b, s, h)))) \
        .astype(np.float32)
    h0 = rng.standard_normal((b, h, dk, dv + normalize)) \
        .astype(np.float32) if with_h0 else None
    return q, k, v, log_a, h0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@settings(max_examples=10, deadline=None)
@given(s=st.integers(1, 70), chunk=st.sampled_from([4, 16, 128]),
       seed=st.integers(0, 5), normalize=st.booleans(),
       with_h0=st.booleans())
def test_chunked_recurrence_matches_jax_and_the_stepwise_oracle(
        s, chunk, seed, normalize, with_h0):
    """The output and ``h_final`` against the reference's chunked form and
    the float64 stepwise oracle, from zeros or a carried-in ``h0``."""
    q, k, v, log_a, h0 = _recurrence_inputs(seed, s, with_h0=with_h0,
                                            normalize=normalize)
    got, got_h = S.chunked_linear_recurrence(*_t(q, k, v, log_a),
                                             chunk=chunk, h0=_t(h0)[0],
                                             normalize=normalize)
    want, want_h = JS.chunked_linear_recurrence(
        *_j(q, k, v, log_a), chunk=chunk, h0=_j(h0)[0], normalize=normalize)
    oracle, oracle_h = _oracle(*(a.astype(np.float64) for a in (q, k, v,
                                                                log_a)),
                               h0=h0, normalize=normalize)
    assert got.shape == (2, s, 3, 5) and got.dtype == torch.float32
    assert got_h.shape == (2, 3, 4, 5 + normalize)
    assert got_h.dtype == torch.float32
    _close(got, want)
    _close(got_h, want_h)
    _close(got, oracle)
    _close(got_h, oracle_h)


@pytest.mark.parametrize("decay", [1.0, 50.0])
@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_recurrence_gradients_match_jax(normalize, decay):
    """Gradients of ``(o·w).sum() + (h_final·w_h).sum()`` in q, k, v,
    log_a and h0 against ``jax.grad``, S 40 in chunks of 16 (padded);
    with ``decay`` 50 ``log_a`` reaches -50 a step, where a mask applied
    after the exp would give ``inf·0``: every gradient must be finite."""
    q, k, v, log_a, h0 = _recurrence_inputs(3, 40, with_h0=True,
                                            normalize=normalize, decay=decay)
    assert log_a.min() < -50 or decay == 1.0
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 40, 3, 5)).astype(np.float32)
    w_h = rng.standard_normal(h0.shape).astype(np.float32)

    def jloss(*args):
        o, hf = JS.chunked_linear_recurrence(*args[:4], chunk=16, h0=args[4],
                                             normalize=normalize)
        return (o * w).sum() + (hf * w_h).sum()
    want = jax.grad(jloss, argnums=tuple(range(5)))(*_j(q, k, v, log_a, h0))
    leaves = [t.requires_grad_() for t in _t(q, k, v, log_a, h0)]
    o, hf = S.chunked_linear_recurrence(*leaves[:4], chunk=16, h0=leaves[4],
                                        normalize=normalize)
    ((o * torch.from_numpy(w)).sum()
     + (hf * torch.from_numpy(w_h)).sum()).backward()
    for name, t, wg in zip(("q", "k", "v", "log_a", "h0"), leaves, want,
                           strict=True):
        assert torch.isfinite(t.grad).all(), name
        _close(t.grad, wg, err_msg=name)


@pytest.mark.parametrize("normalize", [True, False])
def test_single_step_matches_jax_and_the_chunked_form(normalize):
    """``linear_recurrence_step`` against the reference's, step by step
    from a carried-in state, and six steps against the chunked form (the
    twin of ``test_ssm.py::test_single_step_matches_chunked``)."""
    q, k, v, log_a, h0 = _recurrence_inputs(5, 6, b=1, h=2, dk=4, dv=4,
                                            with_h0=True,
                                            normalize=normalize)
    full, h_full = S.chunked_linear_recurrence(*_t(q, k, v, log_a),
                                               chunk=4, h0=_t(h0)[0],
                                               normalize=normalize)
    hstate, jstate, outs = torch.from_numpy(h0), jnp.asarray(h0), []
    for t in range(6):
        args = (q[:, t], k[:, t], v[:, t], log_a[:, t])
        o, hstate = S.linear_recurrence_step(*_t(*args), hstate,
                                             normalize=normalize)
        jo, jstate = JS.linear_recurrence_step(*_j(*args), jstate,
                                               normalize=normalize)
        _close(o, jo)
        _close(hstate, jstate)
        outs.append(o)
    _close(torch.stack(outs, 1), full.numpy())
    _close(hstate, h_full.numpy())


# ------------------------------------------------------------- mamba ----
def _mamba_params(cfg, seed):
    """The reference's ``mamba_init`` weights as numpy, with ``a_log``
    drawn (its init is zeros, which would leave ``exp(a_log)`` out)."""
    p = jax.tree.map(np.array, JS.mamba_init(jax.random.PRNGKey(seed), cfg,
                                             jnp.float32))
    p["a_log"] = np.random.default_rng(seed).normal(
        0.0, 0.5, p["a_log"].shape).astype(np.float32)
    return p


F32_LEAVES = ("w_dt", "a_log")


def test_mamba_init_keeps_the_references_tree():
    """The keys and shapes of the reference's tree; ``w_dt`` and ``a_log``
    f32 in a bf16 model, ``a_log`` zeros, ``w_dt`` at scale 0.02."""
    cfg = get_config(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = S.mamba_init(gen, cfg, torch.bfloat16)
    want = JS.mamba_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    assert set(p) == set(want)
    for name, t in p.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == (torch.float32 if name in F32_LEAVES
                           else torch.bfloat16), name
    assert not p["a_log"].any()
    assert float(p["w_dt"].abs().max()) <= 2 * 0.02


@pytest.mark.parametrize("path", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_jax(dtype, path):
    """``mamba_apply`` on the reference's weights: no state (S 24), a
    prefill from a carried-in state (S 24) and a decode step (S 1) from
    one; the output and the returned state."""
    cfg = _cfg(dtype)
    h, n, dh = cfg.n_heads, cfg.ssm_state, cfg.ssm_head_dim
    p = _mamba_params(cfg, 6)
    rng = np.random.default_rng(6)
    s = 1 if path == "decode" else 24
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state = None if path == "forward" else \
        rng.standard_normal((2, h, n, dh)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k in F32_LEAVES else jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k in F32_LEAVES
                                    else tdt) for k, v in p.items()}
    want, want_state = jax.jit(
        lambda p_, x_, c_: JS.mamba_apply(p_, cfg, x_, cache=c_))(
        jp, jnp.asarray(x, jdt), None if state is None
        else jnp.asarray(state))
    got, got_state = S.mamba_apply(tp, cfg, torch.from_numpy(x).to(tdt),
                                   cache=_t(state)[0])
    assert got.dtype == tdt and got.shape == (2, s, cfg.d_model)
    assert got_state.dtype == torch.float32
    assert got_state.shape == (2, h, n, dh)
    if dtype == "float32":
        _close(got, want)
        _close(got_state, want_state)
    else:
        assert _rel(got, want) <= BF16_TOL
        assert _rel(got_state, want_state) <= BF16_TOL


def test_mamba_apply_gradients_match_jax():
    """Gradients of ``(mamba_apply(x)·w).sum()`` in x and every weight
    (f32, S 40: two chunks of 32 and the padding) against ``jax.grad``."""
    cfg = _cfg()
    p = _mamba_params(cfg, 7)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)

    def jloss(p_, x_):
        return (JS.mamba_apply(p_, cfg, x_)[0] * w).sum()
    wg_p, wg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (S.mamba_apply(tp, cfg, tx)[0] * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, wg_x, err_msg="x")
    for k, v in tp.items():
        _close(v.grad, wg_p[k], err_msg=k)


# ------------------------------------------------------------ models ----
def test_forward_matches_jax():
    cfg = _cfg()
    params, model = _models(cfg)
    toks = _tokens(cfg, (2, 40))
    want = jax.jit(lambda p, t: JT.forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert got.shape == (2, 40, cfg.vocab_size)
    _close(got, want)


def test_forward_bf16_matches_jax():
    cfg = get_config(ARCH, reduced=True)
    assert cfg.dtype == "bfloat16"
    params, model = _models(cfg, seed=3)
    toks = _tokens(cfg, (2, 40), seed=3)
    want = jax.jit(lambda p, t: JT.forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert model.blocks[0].mamba["a_log"].dtype == torch.float32
    assert _rel(got, np.asarray(want, np.float32)) <= BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """One batched prefill of 48 tokens (the 32-slot ring buffer wraps)
    plus 4 decode steps: logits and the three caches (K, V and the f32
    mamba state) array for array after every step; the twin of
    ``tests/test_prefill.py``'s hymba cell against the reference."""
    cfg = _cfg(dtype)
    params, model = _models(cfg, seed=1)
    b, s, gen = 2, 48, 4
    toks = _tokens(cfg, (b, s + gen), seed=1)
    jcache = JT.init_cache(cfg, b, s + gen)
    jdecode = jax.jit(lambda p, t, c, n: JT.decode_step(
        cfg, p, {"tokens": t}, c, n))
    cache = model.init_cache(b, s + gen)
    assert len(cache) == 3 and cache[2].dtype == torch.float32
    assert cache[0].shape[3] == cfg.window < s
    for mine, theirs in zip(cache, jcache, strict=True):
        assert mine.shape == theirs.shape
    tol = TOL if dtype == "float32" else BF16_TOL
    for step in range(gen + 1):
        lo, hi = (0, s) if step == 0 else (s + step - 1, s + step)
        want, jcache = jdecode(params, jnp.asarray(toks[:, lo:hi]), jcache,
                               jnp.int32(lo))
        got, cache = model.decode_step(torch.from_numpy(toks[:, lo:hi]),
                                       cache, lo)
        if dtype == "float32":
            _close(got, want)
        else:
            assert _rel(got, want) <= tol
        for name, mine, theirs in zip("kvs", cache, jcache, strict=True):
            if dtype == "float32":
                _close(mine, theirs, err_msg=name)
            else:
                assert _rel(mine, theirs) <= tol, name


def test_decode_matches_forward():
    """The twin of ``tests/test_models.py::test_decode_matches_forward``
    on the port alone: 8 tokens decoded one at a time against the
    teacher-forced forward, ``REDUCED`` in bf16, at the reference test's
    tolerance for a non-``attn`` block (0.3)."""
    cfg = get_config(ARCH, reduced=True)
    model = T.Transformer(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))
    with torch.inference_mode():
        full = model(toks)
        cache = model.init_cache(2, 8)
        outs = []
        for i in range(8):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
            outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.float().numpy(), 0.3)


def test_ring_buffer_equals_full_window_attention():
    """The twin of ``tests/test_attention.py::
    test_ring_buffer_equals_full_window_attention`` on the port alone: 48
    tokens decoded one at a time through the 32-slot ring buffer against
    the forward's windowed attention, at the reference test's tolerance
    (``rtol`` 0.1, ``atol`` 0.15)."""
    cfg = get_config(ARCH, reduced=True)
    assert cfg.window == 32
    model = T.Transformer(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg, (1, 48), seed=1))
    with torch.inference_mode():
        full = model(toks).float()
        cache = model.init_cache(1, 48)
        assert cache[0].shape[3] == 32
        outs = []
        for i in range(48):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.numpy(), rtol=0.1, atol=0.15)


def _as_tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_train_step_matches_jax():
    """6 AdamW steps against the reference's jitted ``make_train_step``
    (f32, B 2 × S 40: the attention's window and the recurrence's chunk
    both cut the sequence): the step-1 gradients tensor for tensor, the
    losses step for step, each step from the reference's parameters and
    AdamW state loaded into the port."""
    cfg = _cfg()
    params, model = _models(cfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 40))
             for k in ("tokens", "labels")}
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jax_steps.make_loss_fn(cfg, rules=None)
    want_grads = jax.jit(jax.grad(lambda p: loss_fn(p, jb)[0]))(params)
    jstep = jax_steps.make_train_step(
        cfg, JOptConfig(**dataclasses.asdict(ocfg)), rules=None, jit=True)
    jstate = jax_adamw.init(params)
    step = steps.make_train_step(model, ocfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, want = [], []
    for i in range(6):
        model.params_from_jax(params)
        state = adamw.state_from_tree(_as_tensors(tuple(jstate)), model)
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        if i == 0:
            for (name, p), w in zip(model.named_parameters(),
                                    model.from_tree(want_grads)):
                _close(p.grad, np.asarray(w), err_msg=name)
        params, jstate, jm = jstep(params, jstate, jb)
        want.append(float(jm["loss"]))
        assert state.step == int(jstate.step)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert min(losses[2:]) < losses[0], losses


def test_decay_mask_decays_the_mamba_leaves():
    """The reference's rank rule on the stacked tree: ``a_log`` (stacked
    ``(L, h)``) and ``w_dt`` are decayed, and of all parameters only
    ``ln_f`` is not."""
    model = T.Transformer(get_config(ARCH, reduced=True), device="cpu")
    named = dict(zip((n for n, _ in model.named_parameters()),
                     model.decay_mask()))
    assert {n for n, dk in named.items() if not dk} == {"ln_f"}
    assert named["blocks.0.mamba.a_log"] and named["blocks.1.mamba.w_dt"]
    tree = JT.init_params(get_config(ARCH, reduced=True),
                          jax.random.PRNGKey(0))
    assert tree["layers"]["mamba"]["a_log"].ndim == 2


def test_checkpoints_move_both_ways(tmp_path):
    """The reference writes its ``(params, opt_state)`` tree (bf16
    weights, the f32 ``w_dt`` / ``a_log``); the port's ``restore`` reads it
    leaf for leaf, writes it again, and the reference's ``restore`` reads
    the port's step back: the same leaves and manifest text both ways."""
    cfg = get_config(ARCH, reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    jstate = jax_adamw.OptState(
        jnp.int32(3),
        *(jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), params) for _ in range(2)))
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save(d_ref, 3, (params, jstate), extra={"step": 3})

    model = T.Transformer(cfg, device="cpu", seed=1)
    state = adamw.init(model.parameters())
    (ptree, otree), extra = ckpt.restore(d_ref, 3, train._tree(model, state))
    assert extra == {"step": 3}
    model.params_from_jax(ptree)
    state = adamw.state_from_tree(otree, model)
    assert state.step == 3
    for a, b in zip(jax.tree.leaves(model.params_to_jax()),
                    jax.tree.leaves(params), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for a, b in zip(state.mu, model.from_tree(jstate.mu), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    ckpt.save(d_port, 3, train._tree(model, state), extra={"step": 3})
    manifests = [open(os.path.join(d, "step_00000003", "manifest.json")).read()
                 for d in (d_ref, d_port)]
    assert manifests[0] == manifests[1]
    got, extra = jax_ckpt.restore(d_port, 3, (params, jstate))
    assert extra == {"step": 3}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves((params, jstate)),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _tree_size(cfg) -> int:
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


def _shapes_only(monkeypatch):
    """Weights drawn as meta tensors (shapes, no storage), so a model at
    published widths can be counted on the CPU."""
    def empty(gen, shape, scale=None, dtype=torch.float32, device=None):
        return torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(L, "init_weight", empty)
    monkeypatch.setattr(S, "init_weight", empty)


def test_param_count_matches_the_references_tree(monkeypatch):
    """The model holds the reference tree's leaves, element for element:
    at ``REDUCED`` size, and at published widths 1,432,530,400 (reckoned
    from the shapes).  ``param_count()`` (the reference's formula) leaves
    out the norm gains and the mamba heads' ``w_dt`` and ``a_log``."""
    reduced = get_config(ARCH, reduced=True)
    assert reduced.param_count() == jax_get_config(ARCH, reduced=True) \
        .param_count()
    model = T.Transformer(reduced, device="cpu")
    assert _n_params(model) == _tree_size(reduced)
    _shapes_only(monkeypatch)
    full = get_config(ARCH)
    assert _n_params(T.Transformer(full, device="cpu")) == \
        _tree_size(full) == 1_432_530_400
    inner = full.n_heads * full.ssm_head_dim
    gains = (2 * full.n_layers + 1) * full.d_model
    assert full.param_count() == 1_432_530_400 - gains - \
        full.n_layers * (inner * full.n_heads + full.n_heads)


def test_hybrid_clis_serve_and_train_on_the_cpu(capsys):
    """``launch.serve`` (a 40-token prompt wraps the 32-slot ring) and
    ``launch.train`` at ``--reduced --device cpu``: tokens in range,
    finite losses, no kernel launched."""
    ops.reset_launch_counts()
    tokens = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "40", "--gen",
                         "3"])
    assert tokens.shape == (2, 3)
    assert ((tokens >= 0) & (tokens < 256)).all()
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--log-every", "100"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert "sample:" in capsys.readouterr().out
    assert sum(ops.launch_counts().values()) == 0
