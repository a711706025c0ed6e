"""The port's LM against the JAX package: layers, ``forward``, prefill plus
decode with the KV cache, and the greedy serving CLI.

Both packages compute the same model: the reference's ``init_params``
tree is loaded into the port with ``Transformer.params_from_jax``, and
token inputs are made with numpy.  Sizes are the configs' ``REDUCED``
ones.  Tolerances: f32 ``rtol=atol=2e-3`` (the reference's parity bar;
the two sides differ only in summation order and in the attention
algorithm — full softmax against online softmax); the bf16 cell 3e-2
relative to the largest logit, since bf16 rounds at different places in
the two frameworks and the rounding carries through two blocks (seeds 0-3
gave 0.7e-2 to 1.2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = 2e-3
ARCHS = ["qwen2.5-3b", "stablelm-1.6b", "minitron-8b"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _models(cfg, seed=0):
    """The reference's params and a port model loaded with them."""
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    model = T.Transformer(cfg, device="cpu", seed=seed)
    model.params_from_jax(jax.tree.map(np.asarray, params))
    return params, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- layers ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, g = rng.standard_normal((2, 5, 24)), rng.standard_normal(24)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.rms_norm(jnp.asarray(g, jdt), jnp.asarray(x, jdt), 1e-5)
    got = L.rms_norm(torch.tensor(g, dtype=torch.float32).to(tdt),
                     torch.tensor(x, dtype=torch.float32).to(tdt), 1e-5)
    assert got.dtype == tdt
    _close(got, want, TOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("pos_shape", ["seq", "batch"])
def test_apply_rope_matches_jax(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = np.arange(5, 12)
    if pos_shape == "batch":
        pos = np.stack([pos, pos + 30])
        x = x[:, 0]                                    # (B, S, D)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
@pytest.mark.parametrize("sq,h,hkv", [(16, 4, 2), (37, 4, 1), (24, 2, 2)])
def test_chunked_attention_matches_jax(sq, h, hkv, causal, window):
    """GQA k/v repeated to H heads, then the flash kernel's plain version;
    the reference scans kv chunks (chunk 16 here, so a ragged Sk is padded
    and masked)."""
    rng = np.random.default_rng(sq + h)
    q = rng.standard_normal((2, h, sq, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, sq, 8)).astype(np.float32)
            for _ in range(2))
    want = JL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, window=window, chunk=16)
    got = L.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window)
    _close(got, want, 2e-4)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 2, 10, 8)).astype(np.float32)
              for _ in range(2))
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), 6)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), 6)
    _close(got, want, 1e-5)


# -------------------------------------------------------------- model ----
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg = _f32(get_config(arch, reduced=True))
    params, model = _models(cfg)
    toks = _tokens(cfg, (2, 12))
    want = JT.forward(cfg, params, {"tokens": jnp.asarray(toks)})
    got = model(torch.from_numpy(toks))
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, want)


def test_forward_bf16_matches_jax():
    cfg = get_config("qwen2.5-3b", reduced=True)
    assert cfg.dtype == "bfloat16"
    params, model = _models(cfg, seed=3)
    toks = _tokens(cfg, (2, 12), seed=3)
    want = np.asarray(JT.forward(cfg, params, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = model(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.detach().float().numpy() - want).max() / np.abs(
        want).max()
    assert err <= 3e-2, err


@pytest.mark.parametrize("window", [0, 6])
def test_prefill_and_decode_match_jax(window):
    """One batched prefill plus 4 decode steps: logits and both caches after
    every step.  ``window=6`` makes the cache a 6-slot ring buffer, which
    the 8-token prefill overfills."""
    cfg = dataclasses.replace(_f32(get_config("qwen2.5-3b", reduced=True)),
                              window=window)
    params, model = _models(cfg, seed=1)
    b, s, gen = 2, 8, 4
    toks = _tokens(cfg, (b, s + gen), seed=1)
    jcache = JT.init_cache(cfg, b, s + gen)
    cache = model.init_cache(b, s + gen)
    assert cache[0].shape == jcache[0].shape
    for step in range(gen + 1):
        lo, hi = (0, s) if step == 0 else (s + step - 1, s + step)
        want, jcache = JT.decode_step(cfg, params,
                                      {"tokens": jnp.asarray(toks[:, lo:hi])},
                                      jcache, jnp.int32(lo))
        got, cache = model.decode_step(torch.from_numpy(toks[:, lo:hi]),
                                       cache, lo)
        _close(got, want)
        for mine, theirs in zip(cache, jcache):
            _close(mine, theirs)


def test_prefill_logits_equal_forward():
    cfg = _f32(get_config("qwen2.5-3b", reduced=True))
    _, model = _models(cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 10)))
    logits, _ = model.decode_step(toks, model.init_cache(2, 16), 0)
    _close(logits, model(toks).detach().numpy(), 1e-5)
    prefill = steps.make_prefill_step(model)
    _close(prefill(toks), model(toks).detach().numpy(), 0)


def test_serve_main_matches_jax(monkeypatch, capsys):
    """Both CLIs, in f32, on the reference's weights and prompts: the port's
    greedy tokens equal the ones the reference's ``main`` prints and the
    whole ``(batch, gen)`` block of the reference's step loop."""
    cfg = _f32(get_config("qwen2.5-3b", reduced=True))
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "6", "--seed", "4"]
    monkeypatch.setattr(jax_serve, "get_config", lambda *a, **k: cfg)
    jax_serve.main(argv)
    jax_sample = capsys.readouterr().out.split("sample:")[1].strip()

    # the reference main's own weights, prompts and loop
    key = jax.random.PRNGKey(4)
    params = JT.init_params(cfg, key)
    prompts = jax.random.randint(key, (2, 8), 0, cfg.vocab_size)
    step = jax_steps.make_serve_step(cfg, rules=None, jit=True)
    cache = JT.init_cache(cfg, 2, 14)
    tok, cache = step(params, {"tokens": prompts}, cache, jnp.int32(0))
    want = [tok]
    for i in range(5):
        tok, cache = step(params, {"tokens": tok[:, None]}, cache,
                          jnp.int32(8 + i))
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], axis=1)

    def build(cfg_, *, batch, prompt_len, seed, device):
        assert (batch, prompt_len, seed, device) == (2, 8, 4, "cpu")
        model = T.Transformer(cfg_, device=device)
        model.params_from_jax(jax.tree.map(np.asarray, params))
        return model, torch.from_numpy(np.asarray(prompts))

    monkeypatch.setattr(serve, "get_config", lambda *a, **k: cfg)
    monkeypatch.setattr(serve, "build", build)
    got = serve.main(argv + ["--device", "cpu"])
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert str(got[0].tolist()) == jax_sample


def test_serve_main_runs_on_the_cpu(capsys):
    ops.reset_launch_counts()
    tokens = serve.main(["--reduced", "--device", "cpu", "--batch", "3",
                         "--prompt-len", "5", "--gen", "4"])
    assert tokens.shape == (3, 4)
    assert ((tokens >= 0) & (tokens < 256)).all()
    assert "sample:" in capsys.readouterr().out
    assert sum(ops.launch_counts().values()) == 0    # plain path on the CPU


# ------------------------------------------------------ the registry ----
def test_every_reference_arch_resolves_and_builds():
    """Every name of the reference's registry resolves in the port, to the
    reference's fields at full size and at ``REDUCED``, and ``Transformer``
    builds on the CPU for each ``REDUCED`` config."""
    assert sorted(ARCH_NAMES) == sorted(JAX_ARCH_NAMES)
    for arch in JAX_ARCH_NAMES:
        for reduced in (False, True):
            assert dataclasses.asdict(get_config(arch, reduced)) == \
                dataclasses.asdict(jax_get_config(arch, reduced)), arch
        model = T.Transformer(get_config(arch, reduced=True), device="cpu")
        assert model.cfg.name == arch


def test_serve_subgraphs_raise_not_implemented(monkeypatch):
    """``--subgraphs`` is served now (the serving tier, its parity in
    test_torch_serving.py); on its default device, the card, it raises
    where there is none, as the LM loop does."""
    fe = serve.main(["--subgraphs", "4", "--device", "cpu"])
    assert fe.tier.stats["requests"] == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--subgraphs", "4"])


def test_transformer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        T.Transformer(cfg)


def test_params_from_jax_checks_shapes():
    cfg = _f32(get_config("qwen2.5-3b", reduced=True))
    params = jax.tree.map(np.asarray,
                          JT.init_params(cfg, jax.random.PRNGKey(0)))
    small = T.Transformer(dataclasses.replace(cfg, n_layers=1), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        small.params_from_jax(params)
    params["tok"]["embed"] = params["tok"]["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        T.Transformer(cfg, device="cpu").params_from_jax(params)


def test_param_count_matches_the_model():
    """``ModelConfig.param_count`` (copied from the reference) counts the
    port's parameters, less the norm gains and QKV biases it leaves out."""
    cfg = get_config("qwen2.5-3b", reduced=True)
    assert cfg.param_count() == jax_get_config(
        "qwen2.5-3b", reduced=True).param_count()
    model = T.Transformer(cfg, device="cpu")
    n = sum(p.numel() for name, p in model.named_parameters()
            if "ln" not in name and ".b" not in name)
    assert n == cfg.param_count()
