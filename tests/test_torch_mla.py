"""The port's multi-head latent attention and the MLA decoder
(``minicpm3-4b``) against the JAX package: ``mla_init``'s tree,
``mla_attention`` in every path (no cache, a prefill into the latent
cache, decode steps re-expanding the whole cache, the write clamped as
``dynamic_update_slice`` clamps it, the training path) and its gradients,
and the model at its ``REDUCED`` size: forward, prefill plus decode with
the latent cache, decode against forward, 6 train steps, the decay set,
checkpoints both ways, the parameter count and the CLIs.

Inputs are made with numpy from a seed, and the reference's weights are
loaded with ``Transformer.params_from_jax``.  Tolerances: f32
``rtol=atol=2e-3``, the reference's parity bar; bf16 3e-2 relative to the
largest value, as ``test_torch_lm.py`` grounds it; the train steps'
losses 1e-5 relative (each step starts from the reference's state).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jax_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, adamw

TOL = 2e-3
BF16_TOL = 3e-2
ARCH = "minicpm3-4b"


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


# ------------------------------------------------------------ the layer ----
def _mla_params(cfg, seed):
    return jax.tree.map(np.array, JL.mla_init(jax.random.PRNGKey(seed), cfg,
                                              jnp.float32))


def test_mla_init_keeps_the_references_tree():
    """The keys, shapes and dtype of the reference's tree: ``wq (d,
    h·dh)``, ``w_dkv (d, r)``, ``w_uk`` and ``w_uv (r, h·dh)``, ``wo (h·dh,
    d)``, each at ``1/sqrt(fan-in)`` of a truncated normal."""
    cfg = get_config(ARCH, reduced=True)
    p = L.mla_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    want = JL.mla_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    assert set(p) == set(want) == {"wq", "w_dkv", "w_uk", "w_uv", "wo"}
    for name, t in p.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == torch.bfloat16
        assert float(t.float().abs().max()) <= 2.0 / t.shape[0] ** 0.5


#: (path, S, cache_len): no cache; a prefill into a 24-slot latent cache;
#: decode steps mid-cache, at the last slot, and past the end (the write
#: clamped to the last slot, every slot valid)
PATHS = [("forward", 20, None), ("prefill", 20, 0), ("decode", 1, 9),
         ("decode", 1, 23), ("decode", 1, 26)]


@pytest.mark.parametrize("path,s,cache_len", PATHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(dtype, path, s, cache_len):
    """The output and the written latent cache against the reference's
    ``mla_attention`` on the same weights, inputs and cache."""
    cfg = _cfg(dtype)
    p = _mla_params(cfg, 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cache = None if cache_len is None else rng.standard_normal(
        (2, 24, cfg.mla_kv_rank)).astype(np.float32)
    if path == "prefill":
        cache[:] = 0.0
    start = cache_len or 0
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jcache = None if cache is None else jnp.asarray(cache, jdt)
    want, want_cache = jax.jit(
        lambda p_, x_, c_: JL.mla_attention(
            p_, cfg, x_, pos=start + jnp.arange(s), rules=None, cache=c_,
            cache_len=cache_len))(
        {k: jnp.asarray(v, jdt) for k, v in p.items()}, jnp.asarray(x, jdt),
        jcache)
    tcache = None if cache is None else torch.from_numpy(cache).to(tdt)
    got, got_cache = L.mla_attention(
        {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}, cfg,
        torch.from_numpy(x).to(tdt), pos=start + torch.arange(s),
        cache=tcache, cache_len=cache_len)
    assert got.dtype == tdt and got.shape == (2, s, cfg.d_model)
    assert got_cache is tcache                      # written in place
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got, want) <= BF16_TOL
    if cache is not None:
        tol = TOL if dtype == "float32" else BF16_TOL
        assert _rel(got_cache, want_cache) <= tol
        unwritten = np.ones(24, bool)
        unwritten[min(start, 24 - s):min(start, 24 - s) + s] = False
        np.testing.assert_array_equal(
            got_cache[:, unwritten].float().numpy(),
            np.asarray(jcache, np.float32)[:, unwritten])


def test_mla_training_path_is_the_forward_and_matches_jax_grad():
    """``train=True`` (``scan_attention``) gives the no-cache forward's
    output, and its gradients in x and every weight match ``jax.grad`` of
    the reference's layer (f32, S 20)."""
    cfg = _cfg()
    p = _mla_params(cfg, 2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.arange(20)

    def jloss(p_, x_):
        return (JL.mla_attention(p_, cfg, x_, pos=jnp.asarray(pos),
                                 rules=None)[0] * w).sum()
    wg_p, wg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = L.mla_attention(tp, cfg, tx, pos=torch.from_numpy(pos),
                               train=True)
    assert cache is None
    with torch.no_grad():
        plain, _ = L.mla_attention(tp, cfg, tx, pos=torch.from_numpy(pos))
    _close(y, plain.numpy(), 1e-5)
    (y * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, wg_x, err_msg="x")
    for k, v in tp.items():
        _close(v.grad, wg_p[k], err_msg=k)
    with pytest.raises(ValueError, match="latent cache"):
        L.mla_attention(tp, cfg, tx, pos=torch.from_numpy(pos), train=True,
                        cache=torch.zeros(2, 24, cfg.mla_kv_rank),
                        cache_len=0)


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
    toks = _tokens(cfg, (2, 24), seed=3)
    want = jax.jit(lambda p, t: JT.forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert _rel(got, np.asarray(want, np.float32)) <= BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """One batched prefill of 48 tokens plus 4 decode steps: logits and
    the latent cache ``(L, B, max_len, r)`` array for array after every
    step; the twin of ``tests/test_prefill.py``'s minicpm3 cell against
    the reference."""
    cfg = _cfg(dtype)
    params, model = _models(cfg, seed=1)
    b, s, gen = 2, 48, 4
    toks = _tokens(cfg, (b, s + gen), seed=1)
    jcache = JT.init_cache(cfg, b, s + gen)
    jdecode = jax.jit(lambda p, t, c, n: JT.decode_step(
        cfg, p, {"tokens": t}, c, n))
    cache = model.init_cache(b, s + gen)
    assert isinstance(cache, torch.Tensor)
    assert cache.shape == jcache.shape == (cfg.n_layers, b, s + gen,
                                           cfg.mla_kv_rank)
    tol = TOL if dtype == "float32" else BF16_TOL
    for step in range(gen + 1):
        lo, hi = (0, s) if step == 0 else (s + step - 1, s + step)
        want, jcache = jdecode(params, jnp.asarray(toks[:, lo:hi]), jcache,
                               jnp.int32(lo))
        got, cache = model.decode_step(torch.from_numpy(toks[:, lo:hi]),
                                       cache, lo)
        if dtype == "float32":
            _close(got, want)
            _close(cache, jcache)
        else:
            assert _rel(got, want) <= tol
            assert _rel(cache, jcache) <= tol
        assert not cache[:, :, hi:].any()


def test_decode_matches_forward():
    """The twin of ``tests/test_models.py::test_decode_matches_forward``
    on the port alone: 8 tokens decoded one at a time (each step
    re-expanding the whole latent cache) against the teacher-forced
    forward, ``REDUCED`` in bf16, at the reference test's tolerance for an
    ``attn`` block (0.15)."""
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
    _close(torch.stack(outs, dim=1), full.float().numpy(), 0.15)


def _as_tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_train_step_matches_jax():
    """6 AdamW steps against the reference's jitted ``make_train_step``
    (f32, B 2 × S 32): the step-1 gradients tensor for tensor, the losses
    step for step, each step from the reference's parameters and AdamW
    state loaded into the port."""
    cfg = _cfg()
    params, model = _models(cfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32))
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


def test_decay_mask_decays_every_mla_weight():
    """The reference's rank rule on the stacked tree: the five MLA
    projections are decayed, and of all parameters only ``ln_f`` is
    not."""
    model = T.Transformer(get_config(ARCH, reduced=True), device="cpu")
    named = dict(zip((n for n, _ in model.named_parameters()),
                     model.decay_mask()))
    assert {n for n, dk in named.items() if not dk} == {"ln_f"}
    assert {f"blocks.0.attn.{k}" for k in ("wq", "w_dkv", "w_uk", "w_uv",
                                           "wo")} <= set(named)


def test_from_tree_refuses_a_gqa_tree():
    """An MLA model takes only an MLA tree: a GQA block's ``attn`` keys
    (``wk``, ``wv``) are refused by name."""
    cfg = _cfg()
    model = T.Transformer(cfg, device="cpu")
    gqa = JT.init_params(dataclasses.replace(cfg, mla=False),
                         jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="wk"):
        model.params_from_jax(gqa)


def test_checkpoints_move_both_ways(tmp_path):
    """The reference writes its ``(params, opt_state)`` tree (bf16
    weights); the port's ``restore`` reads it leaf for leaf, writes it
    again, and the reference's ``restore`` reads the port's step back: the
    same leaves and manifest text both ways."""
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


def test_param_count_matches_the_references_tree(monkeypatch):
    """The model holds the reference tree's leaves, element for element:
    at ``REDUCED`` size, and at published widths 4,358,341,120 (reckoned
    from the shapes; weights drawn as meta tensors, so nothing is
    allocated); ``param_count()`` counts all but the norm gains."""
    reduced = get_config(ARCH, reduced=True)
    assert reduced.param_count() == jax_get_config(ARCH, reduced=True) \
        .param_count()
    model = T.Transformer(reduced, device="cpu")
    assert _n_params(model) == _tree_size(reduced)

    def empty(gen, shape, scale=None, dtype=torch.float32, device=None):
        return torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(L, "init_weight", empty)
    full = get_config(ARCH)
    assert _n_params(T.Transformer(full, device="cpu")) == \
        _tree_size(full) == 4_358_341_120
    assert full.param_count() == 4_358_341_120 - \
        (2 * full.n_layers + 1) * full.d_model


def test_mla_clis_serve_and_train_on_the_cpu(capsys):
    """``launch.serve`` and ``launch.train`` at ``--reduced --device
    cpu``: tokens in range, finite losses, no kernel launched."""
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
